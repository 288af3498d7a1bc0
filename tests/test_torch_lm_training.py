"""Port parity: the TransformerLM training path of `bigdl_tpu_torch`
against `bigdl_tpu`.

- `TimeDistributedCriterion(ClassNLLCriterion())`, value and gradient,
  summed or averaged over T, weighted or not;
- `Adam`, `AdamW` (also over bf16 parameters through the f32 masters),
  `CosineDecay` and `WarmupCosineDecay`, 5 updates on a small tree;
- the whole `TransformerLM(vocab 64, embed 32, 2 layers, 4 heads)`: every
  parameter's gradient (`lm_params_tree(grad=True)`) against `jax.grad` of
  the JAX model with the same weights, its flash attention run through
  the Pallas forward and backward kernels in interpret mode;
- short training trajectories against the JAX `LocalOptimizer` /
  `Optimizer` from the same weights: 3 steps of the benchmark recipe
  (`DistriOptimizer`, SGD with momentum, the loss summed over T) and 5 of
  the example recipe (`Optimizer` factory, AdamW with warm-up and cosine,
  the loss averaged over T), in f32 and in bf16 compute;
- dropout by its statistics, the dataset pieces, the factory, the
  benchmark loop and the example script on the CPU.

Inputs come from numpy with a fixed seed. Tolerances:
- criterion, optimizers: rtol 1e-6 (the same f32 operations; the
  criterion sums its T steps in another order);
- gradients: per leaf, max|port - JAX| <= 1e-4 * max|JAX| (f32, the same
  math through two frameworks, with attention's sums in another order);
- trajectories: rtol 1e-4 in f32 and 1e-2 in bf16 compute, where every
  matmul output is rounded to bf16 (2**-8 relative) after accumulations
  whose order differs between the frameworks, and the steps carry those
  differences on. The benchmark recipe diverges after a few steps (its
  loss is a sum over T; see `tools/bench.py`), so it is compared over 3.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset.dataset import LocalDataSet as JLocalDataSet
from bigdl_tpu.dataset.sample import MiniBatch as JMiniBatch
from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.nn.module import functional_apply
from bigdl_tpu.ops import attention_kernel as jak
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import (DataSet, LocalDataSet, MiniBatch,
                                     Sample, SampleToMiniBatch)
from bigdl_tpu_torch.interop import (lm_params_tree,
                                     load_transformer_lm_params)
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.nn.attention import TransformerBlock, dropout


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: this file runs JAX beside torch, and under the
    suite's parallel workers torch's intra-op pool and JAX's threads
    oversubscribe the cores (see tests/test_torch_recurrent.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)

VOCAB, EMBED, LAYERS, HEADS = 64, 32, 2, 4


def _jax_lm():
    jm = JaxLM(VOCAB, embed_dim=EMBED, n_layer=LAYERS, n_head=HEADS)
    params = jm.ensure_params(jax.random.PRNGKey(0))
    return jm, jax.tree_util.tree_map(np.asarray, params)


def _port_lm(tree, **kw):
    tm = TransformerLM(VOCAB, embed_dim=EMBED, n_layer=LAYERS,
                       n_head=HEADS, device="cpu", **kw)
    load_transformer_lm_params(tm, tree)
    return tm


def _tokens(b, t, seed):
    rs = np.random.RandomState(seed)
    toks = rs.randint(1, VOCAB + 1, (b, t + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


# --------------------------------------------------------------------------
# TimeDistributedCriterion
# --------------------------------------------------------------------------

@pytest.mark.parametrize("size_average", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_time_distributed_criterion_matches_jax(size_average, weighted):
    rs = np.random.RandomState(1)
    logits = rs.randn(3, 7, 5).astype(np.float32)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    target = rs.randint(1, 6, (3, 7)).astype(np.int32)
    w = rs.rand(5).astype(np.float32) + 0.5 if weighted else None
    jc = jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(weights=w),
                                      size_average=size_average)
    want, want_g = jax.value_and_grad(
        lambda o: jc.loss(o, jnp.asarray(target)))(jnp.asarray(logp))
    tc = tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(weights=w),
                                      size_average=size_average)
    out = torch.from_numpy(logp).requires_grad_()
    got = tc(out, torch.from_numpy(target))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(out.grad.numpy(), np.asarray(want_g),
                               rtol=1e-6, atol=1e-7)


def test_time_distributed_criterion_loops_over_other_inner_criteria():
    """An inner criterion without `losses` gets the reference's loop over
    the steps: the same value as the vectorised path."""

    class Opaque(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.inner = tnn.ClassNLLCriterion()

        def forward(self, o, t):
            return self.inner(o, t)

    rs = np.random.RandomState(2)
    logp = torch.from_numpy(rs.randn(2, 6, 4).astype(np.float32))
    target = torch.from_numpy(rs.randint(1, 5, (2, 6)))
    for dim in (0, 1):
        got = tnn.TimeDistributedCriterion(Opaque(), True, dim)(logp, target)
        want = tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(), True,
                                            dim)(logp, target)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


# --------------------------------------------------------------------------
# Adam, AdamW and the schedules
# --------------------------------------------------------------------------

SHAPES = {"w": (3, 4), "b": (4,), "k": (2, 2, 3)}


def _tree(seed, scale=1.0):
    rs = np.random.RandomState(seed)
    return {k: (rs.randn(*s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


ADAM_CONFIGS = {
    "adam": lambda m: m.Adam(learning_rate=0.01),
    "adam, l2 and lr decay": lambda m: m.Adam(
        learning_rate=0.02, learning_rate_decay=0.3, weight_decay=0.05),
    "adamw, warmup-cosine": lambda m: m.AdamW(
        learning_rate=3e-3, weight_decay=0.01,
        learning_rate_schedule=m.WarmupCosineDecay(2, 5)),
    "adamw, cosine": lambda m: m.AdamW(
        learning_rate=0.05, weight_decay=0.1, beta2=0.99,
        learning_rate_schedule=m.CosineDecay(3, alpha=0.2)),
}


@pytest.mark.parametrize("cfg", list(ADAM_CONFIGS))
def test_adam_family_matches_jax(cfg):
    jm, tm = ADAM_CONFIGS[cfg](joptim), ADAM_CONFIGS[cfg](toptim)
    p0 = _tree(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jm.init_state(jp), tm.init_state(tp)
    for step in range(5):
        g = _tree(10 + step, scale=0.1)
        jlr, tlr = jm.current_lr(), tm.current_lr()
        assert tlr == jlr
        jp, js = jm.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                           jp, jlr)
        tp, ts = tm.update({k: torch.from_numpy(v) for k, v in g.items()},
                           ts, tp, tlr)
        jm.state["neval"] += 1
        tm.state["neval"] += 1
        assert ts["t"] == int(js["t"]) == step + 1
        for k in SHAPES:
            for got, want in ((tp[k], jp[k]), (ts["m"][k], js["m"][k]),
                              (ts["v"][k], js["v"][k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-9,
                                           err_msg=f"{cfg} step {step} {k}")


def test_adamw_bf16_params_update_f32_masters_as_jax():
    kw = dict(learning_rate=0.01, weight_decay=0.1)
    jm, tm = joptim.AdamW(**kw), toptim.AdamW(**kw)
    p0 = _tree(3)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).bfloat16() for k, v in p0.items()}
    js, ts = jm.init_state_with_masters(jp), tm.init_state_with_masters(tp)
    key = toptim.OptimMethod._MASTER_KEY
    for step in range(3):
        g = _tree(30 + step, scale=0.1)
        jp, js = jm.update_with_masters(
            {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()}, js, jp,
            0.01)
        tp, ts = tm.update_with_masters(
            {k: torch.from_numpy(v).bfloat16() for k, v in g.items()}, ts,
            tp, 0.01)
    for k in SHAPES:
        assert tp[k].dtype == torch.bfloat16
        np.testing.assert_allclose(ts[key][k].numpy(),
                                   np.asarray(js[key][k]), rtol=1e-6,
                                   atol=1e-9)


@pytest.mark.parametrize("make", [
    lambda m: m.WarmupCosineDecay(3, 10, alpha=0.1),
    lambda m: m.WarmupCosineDecay(0, 4),
    lambda m: m.CosineDecay(5, alpha=0.2)])
def test_schedules_match_jax(make):
    jsched, tsched = make(joptim), make(toptim)
    jopt = joptim.SGD(learning_rate=0.5)
    topt = toptim.SGD(learning_rate=0.5)
    for n in range(13):
        jopt.state["neval"] = topt.state["neval"] = n
        assert tsched.compute(topt) == jsched.compute(jopt)


def test_schedules_reject_bad_lengths():
    with pytest.raises(ValueError):
        toptim.WarmupCosineDecay(5, 5)
    with pytest.raises(ValueError):
        toptim.CosineDecay(0)


# --------------------------------------------------------------------------
# The whole model's gradients
# --------------------------------------------------------------------------

def test_lm_params_tree_is_the_inverse_of_the_carry():
    _, tree = _jax_lm()
    tm = _port_lm(tree)
    back = dict(_leaves(lm_params_tree(tm)))
    for name, leaf in _leaves(tree):
        np.testing.assert_array_equal(back.pop(name), leaf, err_msg=name)
    assert not back
    with pytest.raises(ValueError, match="grad"):
        lm_params_tree(tm, grad=True)


@pytest.mark.parametrize("size_average", [False, True])
def test_lm_gradients_match_jax_through_pallas_backward(size_average,
                                                        monkeypatch):
    monkeypatch.setattr(jak, "INTERPRET", True)
    jm, tree = _jax_lm()
    x, y = _tokens(2, 64, seed=5)
    jcrit = jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(),
                                         size_average=size_average)

    def jloss(p):
        out, _ = functional_apply(jm, p, jnp.asarray(x), training=True,
                                  rng=jax.random.PRNGKey(1))
        return jcrit.apply(out, jnp.asarray(y))

    params = jax.tree_util.tree_map(jnp.asarray, tree)
    want_loss, want = jax.value_and_grad(jloss)(params)
    tm = _port_lm(tree)
    tm.train()
    loss = tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(),
                                        size_average=size_average)(
        tm(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = dict(_leaves(lm_params_tree(tm, grad=True)))
    for name, leaf in _leaves(jax.tree_util.tree_map(np.asarray, want)):
        err = np.abs(got[name] - leaf).max()
        assert err <= 1e-4 * np.abs(leaf).max(), \
            f"{name}: max error {err:.3e}, max |grad| {np.abs(leaf).max():.3e}"


# --------------------------------------------------------------------------
# Training trajectories against the JAX optimizers
# --------------------------------------------------------------------------

def _jax_bench_run(precision):
    """3 steps of the benchmark recipe on one resident batch."""
    jm, tree = _jax_lm()
    x, y = _tokens(2, 64, seed=6)
    opt = joptim.LocalOptimizer(
        jm, JLocalDataSet([JMiniBatch(x, y)]),
        jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion()))
    opt.set_optim_method(joptim.SGD(learning_rate=0.01, momentum=0.9))
    return opt, tree, x, y


def _port_bench_run(tree, x, y):
    tm = _port_lm(tree)
    opt = toptim.DistriOptimizer(
        tm, LocalDataSet([MiniBatch(x, y)]),
        tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion()),
        devices=["cpu"])
    opt.set_optim_method(toptim.SGD(learning_rate=0.01, momentum=0.9))
    return opt


def _example_data(n=8, t=32):
    from bigdl_tpu_torch.tools.transformer_lm import synthetic_ptb
    toks, _ = synthetic_ptb(n * t + 1, VOCAB, seed=3)
    toks = toks + 1
    X = toks[:n * t].reshape(n, t)
    Y = toks[1:n * t + 1].reshape(n, t)
    return X.astype(np.float32), Y


def _example_method(m):
    return m.AdamW(learning_rate=3e-3, weight_decay=0.01,
                   learning_rate_schedule=m.WarmupCosineDecay(2, 5))


def _jax_example_run(precision):
    """5 steps of the example recipe: one batch holds every sample."""
    jm, tree = _jax_lm()
    X, Y = _example_data()
    opt = joptim.Optimizer(
        jm, (X, Y), jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(),
                                                 size_average=True),
        batch_size=len(X), local=True)
    opt.set_optim_method(_example_method(joptim))
    return opt, tree, X, Y


def _port_example_run(tree, X, Y):
    tm = _port_lm(tree)
    opt = toptim.Optimizer(
        tm, (X, Y), tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(),
                                                 size_average=True),
        batch_size=len(X), local=True, device="cpu")
    assert isinstance(opt, toptim.LocalOptimizer)
    opt.set_optim_method(_example_method(toptim))
    return opt


def _losses(opt, steps, precision, mod):
    opt.set_end_when(mod.max_iteration(steps))
    if precision:
        opt.set_compute_precision(precision)
    losses = []
    opt.set_iteration_hook(lambda s: losses.append(s["loss"]))
    opt.optimize()
    return losses


@pytest.mark.parametrize("recipe,steps", [("bench", 3), ("example", 5)])
@pytest.mark.parametrize("precision,rtol", [(None, 1e-4),
                                            ("bfloat16", 1e-2)])
def test_training_trajectory_matches_jax(recipe, steps, precision, rtol):
    jax_run, port_run = {"bench": (_jax_bench_run, _port_bench_run),
                         "example": (_jax_example_run, _port_example_run)
                         }[recipe]
    jopt, tree, x, y = jax_run(precision)
    want = _losses(jopt, steps, precision, joptim)
    topt = port_run(tree, x, y)
    got = _losses(topt, steps, precision, toptim)
    assert len(got) == len(want) == steps and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=rtol)
    assert all(p.dtype == torch.float32 for p in topt.model.parameters())


# --------------------------------------------------------------------------
# Dropout
# --------------------------------------------------------------------------

def test_dropout_statistics():
    p, n = 0.25, 200_000
    x = torch.ones(n)
    y = dropout(x, p, torch.Generator().manual_seed(3))
    kept = y != 0
    sigma = math.sqrt(p * (1 - p) / n)
    assert abs(kept.float().mean().item() - (1 - p)) <= 4 * sigma
    assert (y[kept] == torch.tensor(1.0) / (1 - p)).all()


def _block(p, seed=0):
    return TransformerBlock(16, 2, causal=True, use_rope=True, dropout=p,
                            device="cpu",
                            generator=torch.Generator().manual_seed(seed))


def test_block_dropout_trains_and_evaluates_as_the_reference():
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 12, 16)
                         .astype(np.float32))
    plain, dropped = _block(0.0), _block(0.4)
    dropped.eval()
    assert torch.equal(dropped(x), plain(x))       # eval: the identity
    plain.train()
    with torch.no_grad():
        want = plain.eval()(x)
        assert torch.equal(plain.train()(x), want)  # p = 0: no dropout path
    dropped.train()
    a = dropped(x)
    assert not torch.allclose(a, want)
    again = _block(0.4)  # a fresh block: the same generator seed, same bits
    again.train()
    assert torch.equal(again(x), a)


def test_lm_passes_one_dropout_generator_to_every_block():
    g = torch.Generator().manual_seed(9)
    tm = TransformerLM(VOCAB, embed_dim=16, n_layer=2, n_head=2,
                       dropout=0.1, device="cpu", dropout_generator=g)
    assert all(b.dropout == 0.1 and b.dropout_generator is g
               for b in tm.blocks)
    with pytest.raises(ValueError, match="dropout"):
        TransformerBlock(16, 2, dropout=1.0, device="cpu")


def test_lm_default_dropout_generator_is_one_for_every_block():
    tm = TransformerLM(VOCAB, embed_dim=16, n_layer=3, n_head=2,
                       dropout=0.1, device="cpu")
    g = tm.blocks[0].dropout_generator
    assert isinstance(g, torch.Generator) and g.initial_seed() == 0
    assert all(b.dropout_generator is g for b in tm.blocks)
    plain = TransformerLM(VOCAB, embed_dim=16, n_layer=2, n_head=2,
                          device="cpu")
    assert all(b.dropout_generator is None for b in plain.blocks)


# --------------------------------------------------------------------------
# Data, the factory, the benchmark and the example on the CPU
# --------------------------------------------------------------------------

def test_samples_batch_into_minibatches():
    feats = np.arange(20, dtype=np.float32).reshape(5, 4)
    labels = np.arange(5, dtype=np.int32)
    ds = DataSet.from_arrays(feats, labels)
    assert ds.size() == 5 and isinstance(ds.items[0], Sample)
    batches = list(ds.transform(SampleToMiniBatch(2)).data(train=False))
    assert [b.size() for b in batches] == [2, 2, 1]
    np.testing.assert_array_equal(batches[1].get_input(), feats[2:4])
    np.testing.assert_array_equal(batches[2].get_target(), labels[4:])
    dropped = ds.transform(SampleToMiniBatch(2, drop_remainder=True))
    assert [b.size() for b in dropped.data(train=False)] == [2, 2]
    assert dropped.size() == 5
    # ragged records pad with 0 to the longest, as the reference's do
    from bigdl_tpu.dataset.sample import MiniBatch as JMiniBatch
    from bigdl_tpu.dataset.sample import Sample as JSample
    ragged = [np.arange(3, dtype=np.float32), np.arange(4, dtype=np.float32)]
    got = MiniBatch.from_samples([Sample(r) for r in ragged]).get_input()
    want = JMiniBatch.from_samples([JSample(r) for r in ragged]).get_input()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 4) and got[0, 3] == 0


def test_optimizer_factory_picks_the_loop(monkeypatch):
    tm = TransformerLM(VOCAB, embed_dim=16, n_layer=1, n_head=2,
                       device="cpu")
    crit = tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion())
    X, Y = _example_data(4, 8)
    opt = toptim.Optimizer(tm, (X, Y), crit, batch_size=2, device="cpu")
    assert isinstance(opt, toptim.LocalOptimizer) and opt.batch_size == 2
    opt = toptim.Optimizer(tm, [Sample(x, y) for x, y in zip(X, Y)], crit,
                           local=False, device="cpu")
    assert isinstance(opt, toptim.DistriOptimizer)
    batches = LocalDataSet([MiniBatch(X, Y)])
    assert toptim.Optimizer(tm, batches, crit, device="cpu").dataset \
        is batches
    with pytest.raises(TypeError):
        toptim.Optimizer(tm, X, crit, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="one process per GPU"):
        toptim.Optimizer(tm, (X, Y), crit, device="cuda:0")


def test_entry_points_raise_without_cuda(monkeypatch):
    from bigdl_tpu_torch.tools import transformer_lm
    from bigdl_tpu_torch.tools.bench import bench_transformer_lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(VOCAB, embed_dim=16, n_layer=1, n_head=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_transformer_lm(device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer_lm.main(["--max-iteration", "2"])


def test_lm_bench_loop_on_the_cpu():
    """The LM benchmark's loop at a tiny size: whole sync windows, one
    loss a step, a first loss near T * ln(vocab) (random weights)."""
    from bigdl_tpu_torch.tools.bench import lm_throughput
    tm = TransformerLM(VOCAB, embed_dim=16, n_layer=1, n_head=2,
                       device="cpu")
    res = lm_throughput(tm, VOCAB, 32, batch_size=2, warmup=2, iters=4,
                        sync=2, device="cpu")
    assert (res["steps"], res["sync"], res["seq"]) == (6, 2, 32)
    assert len(res["losses"]) == 6 and np.all(np.isfinite(res["losses"]))
    assert math.log(VOCAB) < res["losses"][0] / 32 < math.log(VOCAB) + 2
    assert res["tokens_per_sec"] > 0 and res["ms_per_step"] > 0


def test_example_learns_on_the_cpu(capsys):
    from bigdl_tpu_torch.tools import transformer_lm
    ppl = transformer_lm.main(["--device", "cpu", "--max-iteration", "40",
                               "--long-len", "80"])
    out = capsys.readouterr().out
    assert 1 < ppl < 100  # chance is ~200
    assert "T=80" in out
    # --sequence-parallel checks each scheme against naive_attention over
    # 4 shards of the CPU, as the reference's example does
    for scheme in ("ring", "zigzag", "ulysses"):
        transformer_lm.main(["--device", "cpu", "--sequence-parallel",
                             scheme, "--max-iteration", "2",
                             "--long-len", "64"])
        assert f"sequence-parallel ({scheme}) attention over 4 devices " \
            "matches" in capsys.readouterr().out
