"""Port parity: Wide&Deep (`bigdl_tpu_torch/models/widedeep.py`,
`BASELINE.md` config 5) against `bigdl_tpu` on the CPU, with the JAX
weights carried into the port (`interop.load_module_params`), never
re-initialised.

- The forward log-probabilities of the three model types at config 5's
  widths (`WideAndDeep(2, wide_dim=100, embed_vocabs=(10, 10),
  embed_dim=4, cont_dim=3)`) at b8: rtol 1e-5 (atol 1e-6).
- The gradients of the NLL loss against `jax.grad`: rtol 1e-4, atol 1e-7
  (the half a type leaves out gets zeros in both).
- 6 SGD steps (momentum 0.9) through `LocalOptimizer` at b64 in f32
  against the JAX `LocalOptimizer`: losses rtol 1e-5, each parameter
  within 1e-5 of its tensor's largest element (measured: 9e-8 and
  1.2e-7).
- The same in bf16 mixed precision (bf16 compute, f32 masters) against
  the JAX mixed run: losses rtol 1e-3; the parameters' distance from the
  JAX run (a norm over all of them) within 1e-2 of the run's update
  (the same norm of the JAX parameters' change), and each tensor within
  5e-2 of its largest element. Measured over four inits: losses
  1.7e-4-3.1e-4, the distance 2.6e-3-5.0e-3 of the update, a tensor up
  to 2.7e-2 (a bias that moved little). The gathers' gradients, the
  einsum and the log-softmax round to bf16 in both packages, in other
  orders.
- The example recipe (`tools/wide_n_deep.py`: synthetic records, Adam
  5e-3, b128, the `RandomState(epoch)` order) for one epoch from the JAX
  example's init (`ensure_params()`, `PRNGKey(0)`): its mean loss
  against the JAX example's loop (0.6381) at rtol 1e-4, and the records
  equal.
- Checkpoints in format v2 both ways: the port's loads in the reference
  and gives its forward; the reference's resumes the port, which then
  trains on as the reference does.
- `tools/bench.py --model wide_n_deep` at b16 on the CPU: the report's
  keys, a finite loss, and one FLOP count on the CPU and the meta
  device.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset.dataset import LocalDataSet as JLocalDataSet
from bigdl_tpu.dataset.sample import MiniBatch as JMiniBatch
from bigdl_tpu.models.widedeep import WideAndDeep as JWideAndDeep
from bigdl_tpu.nn.module import functional_apply
from bigdl_tpu.serialization import checkpoint as jckpt
from bigdl_tpu.utils.table import T as JT
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
from bigdl_tpu_torch.interop import (load_module_params, load_params,
                                     module_params_tree, params_tree,
                                     tree_from_named)
from bigdl_tpu_torch.models import WideAndDeep
from bigdl_tpu_torch.observability import costs
from bigdl_tpu_torch.tools import bench
from bigdl_tpu_torch.tools import wide_n_deep as example
from bigdl_tpu_torch.utils import T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(wide_dim=100, embed_vocabs=(10, 10), embed_dim=4, cont_dim=3)
TYPES = ["wide_n_deep", "wide", "deep"]
STEPS = 6


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


@functools.lru_cache(maxsize=None)
def _jax_init(seed):
    """The JAX model's params from `PRNGKey(seed)` (every part is built
    whatever the model type, so one tree serves the three)."""
    return _np(jax.jit(JWideAndDeep(2, **CFG).init)(
        jax.random.PRNGKey(seed)))


def _pair(model_type="wide_n_deep", seed=0):
    """A JAX model initialised from `seed`, and the port's with its
    weights; the params as numpy."""
    jm = JWideAndDeep(2, **CFG, model_type=model_type)
    params = _np(_jax_init(seed))
    jm.set_params(jax.tree_util.tree_map(jnp.asarray, params))
    tm = WideAndDeep(2, **CFG, model_type=model_type, device="cpu")
    load_module_params(tm, params)
    return jm, tm, params


def _batch(b, seed=1):
    return bench._wide_n_deep_batch(b, seed=seed)


def _close_tree(got, want, rtol, atol, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close_tree(got[k], want[k], rtol, atol, f"{path}/{k}")
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=path)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def test_the_parameter_tree_is_the_reference_s():
    jm, tm, params = _pair()
    got = params_tree(tm)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(params)
    _close_tree(got, params, 0, 0)
    # load_params takes it back as it is
    other = WideAndDeep(2, **CFG, device="cpu",
                        generator=torch.Generator().manual_seed(5))
    load_params(other, params)
    _close_tree(params_tree(other), params, 0, 0)
    assert [type(m) for m in (tm.wide, tm.embed0, tm.embed1)] == \
        [tnn.SparseLinear, tnn.LookupTable, tnn.LookupTable]


@pytest.mark.parametrize("model_type", TYPES)
def test_forward_matches_the_reference(model_type):
    jm, tm, params = _pair(model_type)
    x, _ = _batch(8)
    want, _ = functional_apply(jm, jax.tree_util.tree_map(jnp.asarray,
                                                          params),
                               JT(*[jnp.asarray(v) for v in x]),
                               training=False)
    got = tm.eval()(T(*[torch.from_numpy(v) for v in x]))
    assert got.shape == (8, 2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("model_type", TYPES)
def test_gradients_match_jax_grad(model_type):
    jm, tm, params = _pair(model_type)
    x, y = _batch(8, seed=4)
    crit = jnn.ClassNLLCriterion()

    def loss(p):
        out, _ = functional_apply(jm, p, JT(*[jnp.asarray(v) for v in x]),
                                  training=True)
        return crit(out, jnp.asarray(y))

    want = _np(jax.grad(loss)(jax.tree_util.tree_map(jnp.asarray, params)))
    out = tm.train()(T(*[torch.from_numpy(v) for v in x]))
    tloss = tnn.ClassNLLCriterion()(out, torch.from_numpy(y))
    named = dict(tm.named_parameters())
    grads = torch.autograd.grad(tloss, list(named.values()),
                                allow_unused=True, materialize_grads=True)
    got = tree_from_named(tm, dict(zip(named, grads)))
    _close_tree(got, want, 1e-4, 1e-7)


def _trajectories(precision, b=64, steps=STEPS):
    """(JAX losses, params0, JAX params after, port losses, port params
    after) of `steps` SGD steps on one batch through each
    LocalOptimizer."""
    jm, tm, params0 = _pair()
    x, y = _batch(b, seed=6)
    jopt = joptim.LocalOptimizer(jm, JLocalDataSet([JMiniBatch(x, y)]),
                                 jnn.ClassNLLCriterion())
    topt = toptim.LocalOptimizer(tm, LocalDataSet([MiniBatch(x, y)]),
                                 tnn.ClassNLLCriterion(), device="cpu")
    runs = []
    for opt, pkg in ((jopt, joptim), (topt, toptim)):
        opt.set_optim_method(pkg.SGD(learning_rate=0.01, momentum=0.9))
        opt.set_end_when(pkg.max_iteration(steps))
        if precision:
            opt.set_compute_precision(precision)
        losses = []
        opt.set_iteration_hook(lambda s, losses=losses: losses.append(
            s["loss"]))
        opt.optimize()
        runs.append(losses)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    return runs[0], params0, _np(jm.ensure_params()), runs[1], \
        module_params_tree(tm)


def test_f32_training_matches_the_reference():
    j_losses, _, j_params, t_losses, t_params = _trajectories(None)
    assert len(t_losses) == STEPS and np.all(np.isfinite(t_losses))
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    for (path, got), (_, want) in zip(_leaves(t_params),
                                      _leaves(j_params)):
        np.testing.assert_allclose(
            got, want, rtol=0, atol=1e-5 * max(np.abs(want).max(), 1e-6),
            err_msg=path)


def test_bf16_mixed_training_matches_the_reference():
    j_losses, p0, j_params, t_losses, t_params = _trajectories("bfloat16")
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-3)
    got, want, start = (dict(_leaves(t)) for t in (t_params, j_params, p0))
    apart = np.sqrt(sum(((got[k] - want[k]) ** 2).sum() for k in want))
    moved = np.sqrt(sum(((want[k] - start[k]) ** 2).sum() for k in want))
    assert moved > 0 and apart <= 1e-2 * moved, (apart, moved)
    for k in want:
        np.testing.assert_allclose(
            got[k], want[k], rtol=0,
            atol=5e-2 * max(np.abs(want[k]).max(), 1e-6), err_msg=k)


def _jax_example_epoch(params, data, labels, batch_size=128):
    """The reference example's loop (`examples/wide_n_deep.py`) for one
    epoch: its mean loss."""
    jm = JWideAndDeep(class_num=2, wide_dim=200, embed_vocabs=(50, 30, 20),
                      cont_dim=4)
    crit = jnn.ClassNLLCriterion()
    method = joptim.Adam(learning_rate=5e-3)
    opt_state = method.init_state(params)

    def step(p, s, batch, y):
        def loss_fn(q):
            out, _ = functional_apply(jm, q, JT(*batch), training=True)
            return crit(out, y)

        loss, grads = jax.value_and_grad(loss_fn)(p)
        p2, s2 = method.update(grads, s, p, method.current_lr())
        return p2, s2, loss

    jstep = jax.jit(step)
    perm = np.random.RandomState(0).permutation(len(labels))
    losses = []
    for i in range(0, len(labels) - batch_size + 1, batch_size):
        sel = perm[i:i + batch_size]
        params, opt_state, loss = jstep(
            params, opt_state, tuple(jnp.asarray(d[sel]) for d in data),
            jnp.asarray(labels[sel]))
        losses.append(float(loss))
    return float(np.mean(losses))


def test_the_example_recipe_matches_the_reference_s_first_epoch():
    spec = importlib.util.spec_from_file_location(
        "_ref_wide_n_deep", os.path.join(REPO, "examples", "wide_n_deep.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    data, labels = example.synthetic_recs()
    ref_data, ref_labels = ref.synthetic_recs(wide_dim=200,
                                              vocabs=(50, 30, 20),
                                              cont_dim=4)
    for a, b in zip(data, ref_data):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(labels, ref_labels)
    jm = JWideAndDeep(class_num=2, wide_dim=200, embed_vocabs=(50, 30, 20),
                      cont_dim=4)
    params = jm.ensure_params()
    want = _jax_example_epoch(params, data, labels)
    assert round(want, 4) == 0.6381
    tm = WideAndDeep(class_num=2, wide_dim=200, embed_vocabs=(50, 30, 20),
                     cont_dim=4, device="cpu")
    load_module_params(tm, _np(params))
    losses, acc = example.train(tm, data, labels, max_epoch=1, log=None)
    np.testing.assert_allclose(losses[0], want, rtol=1e-4)
    assert 0.5 < acc <= 1.0


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    jm, tm, _ = _pair()
    x, y = _batch(16, seed=8)
    opt = toptim.LocalOptimizer(tm, LocalDataSet([MiniBatch(x, y)]),
                                tnn.ClassNLLCriterion(), device="cpu")
    opt.set_optim_method(toptim.SGD(0.05, momentum=0.9))
    opt.set_checkpoint(str(tmp_path), toptim.several_iteration(2))
    opt.set_end_when(toptim.max_iteration(2))
    opt.optimize()
    ckpt = jckpt.latest_checkpoint(str(tmp_path))
    jckpt.verify_checkpoint(ckpt)
    params, state, blob = jckpt.load_checkpoint(ckpt)
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(_np(jm.ensure_params()))
    assert jax.tree_util.tree_structure(blob["slots"]["velocity"]) == \
        jax.tree_util.tree_structure(params)
    want, _ = functional_apply(jm, jax.tree_util.tree_map(jnp.asarray,
                                                          params),
                               JT(*[jnp.asarray(v) for v in x]),
                               training=False)
    got = tm.eval()(T(*[torch.from_numpy(v) for v in x]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_reference_checkpoint_resumes_the_port(tmp_path):
    jm, _, _ = _pair()
    x, y = _batch(16, seed=10)
    path = str(tmp_path / "ref")
    jopt = joptim.LocalOptimizer(jm, JLocalDataSet([JMiniBatch(x, y)]),
                                 jnn.ClassNLLCriterion())
    jopt.set_optim_method(joptim.SGD(learning_rate=0.05, momentum=0.9))
    jopt.set_checkpoint(path, joptim.several_iteration(2))
    jopt.set_end_when(joptim.max_iteration(4))
    j_losses = []
    jopt.set_iteration_hook(lambda s: j_losses.append(s["loss"]))
    jopt.optimize()
    # the port resumes from the reference's step-2 checkpoint
    tm = WideAndDeep(2, **CFG, device="cpu",
                     generator=torch.Generator().manual_seed(3))
    resume = tmp_path / "resume"
    resume.mkdir()
    os.rename(os.path.join(path, "iter2"), resume / "iter2")
    opt = toptim.LocalOptimizer(tm, LocalDataSet([MiniBatch(x, y)]),
                                tnn.ClassNLLCriterion(), device="cpu")
    opt.set_optim_method(toptim.SGD())
    opt.set_checkpoint(str(resume), toptim.several_iteration(100))
    assert opt.resume_from_latest_checkpoint()
    assert opt.optim_method.state["neval"] == 2
    losses = []
    opt.set_iteration_hook(lambda s: losses.append(s["loss"]))
    opt.set_end_when(toptim.max_iteration(4))
    opt.optimize()
    np.testing.assert_allclose(losses, j_losses[2:], rtol=1e-5)
    _close_tree(module_params_tree(tm), _np(jm.ensure_params()), 0, 1e-6)


def test_bench_wide_n_deep_on_the_cpu():
    res = bench.bench_wide_n_deep(batch_size=16, warmup=2, iters=2, sync=2,
                                  device="cpu")
    assert res["model"] == "wide_n_deep" and res["batch_size"] == 16
    assert res["records_per_sec"] > 0 and res["mfu"] is None
    assert len(res["losses"]) == 4 and np.all(np.isfinite(res["losses"]))
    # the meta count equals a real step's count on the CPU; the sparse
    # layer's einsum (a bmm) counts, the gathers count nothing
    x, y = bench._wide_n_deep_batch(16)
    opt = bench._resident_optimizer(bench.wide_n_deep_model("cpu"), x, y,
                                    tnn.ClassNLLCriterion(), torch.device(
                                        "cpu"))
    real = costs.count_flops(opt._build_step(),
                             opt.optim_method.init_state_with_masters(
                                 dict(opt.model.named_parameters())),
                             T(*[torch.from_numpy(v) for v in x]),
                             torch.from_numpy(y), 0.01)
    assert res["flops_per_step"] == real
    deep_forward = 2 * 16 * (11 * 100 + 100 * 50 + 50 * 2)
    wide_forward = 2 * 16 * 3 * 2
    assert 3 * deep_forward < real < 3 * (deep_forward + wide_forward) + 1
    with pytest.raises(ValueError, match="CUDA"):
        bench.profile_wide_n_deep(device="cpu")
