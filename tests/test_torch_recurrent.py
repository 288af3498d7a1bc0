"""Port parity: the recurrent path of `bigdl_tpu_torch` (`LookupTable`, the
cells, `Recurrent`, `TimeDistributed`, `PTBModel`, `SimpleRNN`,
`TimeDistributedMaskCriterion`, the PTB benchmark and example) against
`bigdl_tpu`, with the JAX model's parameters carried into the port
(`interop.load_module_params`), never initialised anew.

Inputs come from numpy with fixed seeds. Layers and cells compare outputs
and the gradients of `sum(out * w)` (a random `w`) with respect to the
input and the parameters against `jax.value_and_grad` of the reference;
the models compare the forward and the gradients of their training loss,
then take 3 SGD steps (momentum 0.9) through the port's
`DistriOptimizer` against the reference's `SGD.update` over
`jax.value_and_grad` of the same loss.

Tolerances, all f32 (tests/conftest.py sets JAX's matmul precision to
"highest"):
- layers, cells and model forwards: atol 1e-5 (the same products summed
  in another order; the forward of a model within a relative 1e-5 of its
  largest output);
- gradients and trajectories: each within 1e-4 of its tensor's largest
  element, losses within a relative 1e-4;
- `Dropout` is held by its statistics only (the port draws its bits from
  a `torch.Generator`, the reference from a JAX key);
- the full-size PTB parameter tree (keys, shapes) equals the JAX
  model's, taken with `jax.eval_shape`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.models import rnn as jrnn
from bigdl_tpu.nn.module import functional_apply
from bigdl_tpu.utils.table import T as JT
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch import models as tmodels
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
from bigdl_tpu_torch.interop import load_module_params, module_params_tree
from bigdl_tpu_torch.interop.jax_params import _module_targets
from bigdl_tpu_torch.observability import costs
from bigdl_tpu_torch.tools import bench
from bigdl_tpu_torch.utils import T, Table

ATOL = 1e-5
GRAD_RTOL = 1e-4
#: the small PTB configuration: vocabulary, hidden width, batch, steps
VOCAB, HIDDEN, B, STEPS = 50, 16, 4, 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The recurrent steps are many small ops. Once JAX has started its
    own threads in the process, torch's intra-op pool of one thread a
    core spends ~100x the work's time waiting on the others (measured on
    the CPU: a PTB step at b32 4.1 s with 8 threads, 0.04 s with 1), so
    this file runs torch on one thread and puts the setting back after."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _x(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _carry(jmod, tmod, seed=1):
    params = _np(jmod.init(jax.random.PRNGKey(seed)))
    load_module_params(tmod, params)
    return params


def _close_tree(got, want, rtol=GRAD_RTOL):
    """Every leaf within rtol of its tensor's largest element."""
    gl, gd = jax.tree_util.tree_flatten(got)
    wl, wd = jax.tree_util.tree_flatten(want)
    assert gd == wd
    for a, b in zip(gl, wl):
        b = np.asarray(b)
        np.testing.assert_allclose(
            np.asarray(a), b, rtol=0,
            atol=rtol * max(float(np.abs(b).max()), 1e-6))


def _check(jmod, tmod, x, params, atol=ATOL, grad_x=True):
    """Output, d/dx (with `grad_x`) and d/dparams of sum(out * w) in
    training mode, port against reference."""
    out0, _ = functional_apply(jmod, params, jnp.asarray(x), training=True)
    w = np.random.RandomState(9).randn(*np.shape(out0)).astype(np.float32)
    floating = grad_x

    def f(p, xx):
        out, _ = functional_apply(jmod, p, xx, training=True)
        return jnp.sum(out * w), out
    argnums = (0, 1) if floating else 0
    (_, out_j), grads = jax.jit(jax.value_and_grad(
        f, argnums=argnums, has_aux=True))(params, jnp.asarray(x))
    gp_j = grads[0] if floating else grads
    xt = torch.from_numpy(x)
    if floating:
        xt.requires_grad_()
    out_t = tmod.train()(xt)
    (out_t * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=atol, rtol=0)
    if floating:
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(grads[1]),
                                   atol=atol, rtol=0)
    _close_tree(module_params_tree(tmod, grad=True), _np(gp_j))
    return out_t.detach().numpy()


# --------------------------------------------------------------------------
# LookupTable
# --------------------------------------------------------------------------

#: (constructor keywords after (n_index, n_output), ids): ids 0 and below
#: give the zero row, ids past the end the last row
LOOKUP_CASES = {
    "one_based": ({}, np.array([[1, 2, 0], [10, 11, 3]], np.int32)),
    "float_ids": ({}, np.array([[1.0, 2.7, 0.0], [10.0, 4.2, 3.0]],
                               np.float32)),
    "padding_value": ({"padding_value": 3},
                      np.array([[3, 2, 1], [3, 9, 4]], np.int32)),
    "max_norm": ({"max_norm": 1.5}, np.array([[1, 2, 2], [5, 9, 4]],
                                             np.int32)),
    "max_norm_l1": ({"max_norm": 2.0, "norm_type": 1.0},
                    np.array([[1, 7, 2], [5, 9, 1]], np.int32)),
    "zero_based": ({"one_based": False},
                   np.array([[0, 1, 9], [4, -1, 3]], np.int32)),
}


@pytest.mark.parametrize("case", sorted(LOOKUP_CASES))
def test_lookup_table_matches_the_reference(case):
    kw, ids = LOOKUP_CASES[case]
    jm = jnn.LookupTable(10, 5, **kw)
    tm = tnn.LookupTable(10, 5, **kw, device="cpu")
    params = _carry(jm, tm)
    out = _check(jm, tm, ids, params, grad_x=False)
    zero_rows = (ids.astype(np.int32) < (1 if kw.get("one_based", True)
                                         else 0))
    if "padding_value" in kw:
        zero_rows |= ids == kw["padding_value"]
    assert zero_rows.any() == (case not in ("max_norm", "max_norm_l1"))
    assert np.all(out[zero_rows] == 0)
    if "max_norm" in kw:
        norms = np.linalg.norm(out.reshape(-1, 5), ord=kw.get(
            "norm_type", 2.0), axis=1)
        assert np.all(norms <= kw["max_norm"] + 1e-5)


def test_lookup_table_default_init_is_standard_normal():
    w = tnn.LookupTable(4000, 50, device="cpu").weight.detach()
    assert abs(float(w.mean())) < 0.01 and abs(float(w.std()) - 1) < 0.01


# --------------------------------------------------------------------------
# Cells, Recurrent, TimeDistributed
# --------------------------------------------------------------------------

def _cells(pkg, device_kw):
    return {
        "rnn": lambda: pkg.RnnCell(3, 5, **device_kw),
        "lstm": lambda: pkg.LSTMCell(3, 5, **device_kw),
        "lstm_forget_bias": lambda: pkg.LSTMCell(3, 5, 0.0, 1.0,
                                                 **device_kw),
        "multi": lambda: pkg.MultiRNNCell([pkg.LSTMCell(3, 5, **device_kw),
                                           pkg.RnnCell(5, 4, **device_kw)]),
    }


def _state(kind, seed):
    rs = np.random.RandomState(seed)

    def h(n):
        return rs.randn(2, n).astype(np.float32)
    return {"rnn": h(5), "lstm": (h(5), h(5)),
            "lstm_forget_bias": (h(5), h(5)),
            "multi": ((h(5), h(5)), h(4))}[kind]


@pytest.mark.parametrize("kind", ["rnn", "lstm", "lstm_forget_bias",
                                  "multi"])
def test_cell_single_step_through_a_table(kind):
    """forward(T(x, state)) -> T(out, new_state), as the reference's
    apply: the output, every state leaf, and d sum(out * w)/dparams."""
    jc, tc = _cells(jnn, {})[kind](), _cells(tnn, {"device": "cpu"})[kind]()
    params = _carry(jc, tc)
    x, state = _x(2, 3, seed=2), _state(kind, 3)
    jstate = jax.tree_util.tree_map(jnp.asarray, state)
    tstate = jax.tree_util.tree_map(torch.from_numpy, state)
    out_j = jax.jit(lambda p, xx, st: functional_apply(
        jc, p, JT(xx, st))[0])(params, jnp.asarray(x), jstate)
    out_t = tc(T(torch.from_numpy(x), tstate))
    assert isinstance(out_t, Table) and len(out_t) == 2
    np.testing.assert_allclose(out_t[1].detach().numpy(),
                               np.asarray(out_j[1]), atol=ATOL, rtol=0)
    got_s = jax.tree_util.tree_map(lambda t: t.detach().numpy(), out_t[2])
    _close_tree(got_s, _np(out_j[2]), rtol=ATOL)
    w = _x(*out_t[1].shape, seed=4)

    def f(p):
        out, _ = functional_apply(jc, p, JT(jnp.asarray(x), jstate))
        return jnp.sum(out[1] * w)
    (out_t[1] * torch.from_numpy(w)).sum().backward()
    _close_tree(module_params_tree(tc, grad=True),
                _np(jax.jit(jax.grad(f))(params)))


@pytest.mark.parametrize("return_sequences,reverse",
                         [(True, False), (False, False), (True, True),
                          (False, True)])
def test_recurrent_matches_the_reference(return_sequences, reverse):
    jm = jnn.Recurrent(jnn.LSTMCell(3, 5), return_sequences, reverse)
    tm = tnn.Recurrent(tnn.LSTMCell(3, 5, device="cpu"), return_sequences,
                       reverse)
    params = _carry(jm, tm)
    out = _check(jm, tm, _x(2, 4, 3, seed=5), params)
    assert out.shape == ((2, 4, 5) if return_sequences else (2, 5))


def test_recurrent_over_a_stack_and_time_distributed():
    jm = (jnn.Sequential()
          .add(jnn.Recurrent(jnn.MultiRNNCell([jnn.RnnCell(3, 6),
                                                jnn.LSTMCell(6, 5)])))
          .add(jnn.TimeDistributed(jnn.Linear(5, 4))))
    tm = (tnn.Sequential()
          .add(tnn.Recurrent(tnn.MultiRNNCell([
              tnn.RnnCell(3, 6, device="cpu"),
              tnn.LSTMCell(6, 5, device="cpu")])))
          .add(tnn.TimeDistributed(tnn.Linear(5, 4, device="cpu"))))
    params = _carry(jm, tm)
    assert [n for n, _ in tm.named_parameters()] == [
        "0_Recurrent.cell.cell0.wi", "0_Recurrent.cell.cell0.wh",
        "0_Recurrent.cell.cell0.bias", "0_Recurrent.cell.cell1.wi",
        "0_Recurrent.cell.cell1.wh", "0_Recurrent.cell.cell1.bias",
        "1_TimeDistributed.layer.weight", "1_TimeDistributed.layer.bias"]
    _check(jm, tm, _x(2, 5, 3, seed=6), params)


def test_time_distributed_folds_time_into_the_batch():
    jm = jnn.TimeDistributed(jnn.Linear(3, 4))
    tm = tnn.TimeDistributed(tnn.Linear(3, 4, device="cpu"))
    params = _carry(jm, tm)
    out = _check(jm, tm, _x(2, 5, 3, seed=7), params)
    assert out.shape == (2, 5, 4)


# --------------------------------------------------------------------------
# PTBModel and SimpleRNN
# --------------------------------------------------------------------------

def _batch(kind, seed=0):
    rs = np.random.RandomState(seed)
    if kind == "ptb":
        x = rs.randint(1, VOCAB, (B, STEPS)).astype(np.int32)
        y = rs.randint(1, VOCAB, (B, STEPS)).astype(np.int32)
    else:
        x = rs.randn(B, STEPS, 4).astype(np.float32)
        y = rs.randint(1, 5, (B, STEPS)).astype(np.int32)
    return x, y


def _port_model(kind):
    if kind == "ptb":
        return tmodels.PTBModel(VOCAB, HIDDEN, VOCAB, device="cpu")
    return tmodels.SimpleRNN(4, HIDDEN, 4, device="cpu")


#: kind -> (JAX model, its params, jitted value_and_grad of the summed
#: TimeDistributed NLL returning the output too), built once per kind
_JAX_CASES = {}


def _jax_case(kind):
    if kind not in _JAX_CASES:
        jm = jrnn.PTBModel(VOCAB, HIDDEN, VOCAB) if kind == "ptb" \
            else jrnn.SimpleRNN(4, HIDDEN, 4)
        crit = jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion())

        def loss(p, x, y):
            out, _ = functional_apply(jm, p, x, training=True)
            return crit(out, y), out
        params = _np(jm.init(jax.random.PRNGKey(1)))
        _JAX_CASES[kind] = (jm, params, jax.jit(
            jax.value_and_grad(loss, has_aux=True)))
    return _JAX_CASES[kind]


@pytest.mark.parametrize("kind", ["ptb", "simple_rnn"])
def test_model_forward_and_gradients_match(kind):
    _, params, vg = _jax_case(kind)
    tm = _port_model(kind)
    load_module_params(tm, params)
    x, y = _batch(kind)
    assert set(params) == set(_module_targets(tm))
    (lj, out_j), gj = vg(params, jnp.asarray(x), jnp.asarray(y))
    out_j = np.asarray(out_j)
    out_t = tm.train()(torch.from_numpy(x))
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, rtol=0,
                               atol=1e-5 * np.abs(out_j).max())
    tcrit = tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion())
    lt = tcrit(out_t, torch.from_numpy(y))
    lt.backward()
    assert abs(float(lt.detach()) - float(lj)) <= 1e-5 * abs(float(lj))
    _close_tree(module_params_tree(tm, grad=True), _np(gj))


@pytest.mark.parametrize("kind", ["ptb", "simple_rnn"])
def test_three_step_trajectory_matches(kind):
    """3 SGD steps (momentum 0.9) through the port's DistriOptimizer
    against the reference's SGD.update over jax.value_and_grad."""
    _, params, vg = _jax_case(kind)
    tm = _port_model(kind)
    load_module_params(tm, params)
    x, y = _batch(kind, seed=1)
    method = joptim.SGD(learning_rate=0.1, momentum=0.9)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    st = method.init_state(p)
    want = []
    for _ in range(3):
        (loss, _), g = vg(p, jnp.asarray(x), jnp.asarray(y))
        p, st = method.update(g, st, p, 0.1)
        want.append(float(loss))
    opt = toptim.DistriOptimizer(
        tm, LocalDataSet([MiniBatch(x, y)]),
        tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion()),
        devices=["cpu"])
    opt.set_optim_method(toptim.SGD(learning_rate=0.1, momentum=0.9))
    opt.set_end_when(toptim.max_iteration(3))
    got = []
    opt.set_iteration_hook(lambda s: got.append(s["loss"]))
    opt.optimize()
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL)
    _close_tree(module_params_tree(tm), _np(p))


def test_ptb_dropout_statistics_and_paths():
    """keep_prob = 0.5: the reference's module names (a Dropout after the
    embedding and after the LSTM stack), and in training about half of
    each Dropout's elements zeroed, the rest doubled; eval mode is the
    identity."""
    jm = jrnn.PTBModel(VOCAB, HIDDEN, VOCAB, keep_prob=0.5)
    tm = tmodels.PTBModel(VOCAB, HIDDEN, VOCAB, keep_prob=0.5, device="cpu")
    with jax.ensure_compile_time_eval():
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    assert list(shapes) == [k for k, _ in tm.named_children()] == [
        "0_LookupTable", "1_Dropout", "2_Recurrent", "3_Dropout",
        "4_TimeDistributed", "5_TimeDistributed"]
    seen = []
    for m in tm.modules():
        if isinstance(m, tnn.Dropout):
            m.register_forward_hook(lambda _, i, o: seen.append((i[0], o)))
    x = np.random.RandomState(2).randint(1, VOCAB, (64, 20)).astype(
        np.int32)
    with tnn.lend_generator(torch.Generator().manual_seed(0)):
        tm.train()(torch.from_numpy(x))
    assert len(seen) == 2
    for i, o in seen:
        nz = i != 0
        dropped = float(((o == 0) & nz).sum() / nz.sum())
        assert abs(dropped - 0.5) < 0.03
        kept = (o != 0)
        torch.testing.assert_close(o[kept], 2 * i[kept])
    # eval mode: the model without the Dropouts, on the same weights
    plain = tmodels.PTBModel(VOCAB, HIDDEN, VOCAB, device="cpu")
    tree = module_params_tree(tm)
    load_module_params(plain, {
        "0_LookupTable": tree["0_LookupTable"],
        "1_Recurrent": tree["2_Recurrent"],
        "2_TimeDistributed": tree["4_TimeDistributed"],
        "3_TimeDistributed": tree["5_TimeDistributed"]})
    xt = torch.from_numpy(x[:2])
    torch.testing.assert_close(tm.eval()(xt), plain.eval()(xt), rtol=0,
                               atol=0)


def test_full_size_ptb_tree_matches_the_reference():
    """PTBModel(10001, 200, 10001): the same parameter paths and shapes
    as the JAX model's `init` (taken with `jax.eval_shape`)."""
    jm = jrnn.PTBModel(10001, 200, 10001)
    with jax.ensure_compile_time_eval():
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tm = tmodels.PTBModel(10001, 200, 10001, device="meta")
    want = jax.tree_util.tree_map(lambda s: tuple(s.shape), shapes)
    got = jax.tree_util.tree_map(lambda p: tuple(p.shape),
                                 _module_targets(tm))
    assert got == want
    # the embedding, two LSTM layers (wi, wh, bias) and the projection
    assert sum(p.numel() for p in tm.parameters()) == (
        10001 * 200 + 2 * (2 * 200 * 800 + 800) + 200 * 10001 + 10001)


# --------------------------------------------------------------------------
# TimeDistributedMaskCriterion
# --------------------------------------------------------------------------

@pytest.mark.parametrize("inner,padding_value",
                         [("nll", 0), ("nll", 3), ("mse", 0)])
def test_time_distributed_mask_criterion(inner, padding_value):
    """Value and gradient on [4, 6, 11] outputs with padded targets:
    log-probabilities under a ClassNLLCriterion, logits otherwise."""
    rs = np.random.RandomState(3)
    out = rs.randn(4, 6, 11).astype(np.float32)
    if inner == "nll":
        out = np.asarray(jax.nn.log_softmax(jnp.asarray(out), -1))
    tgt = rs.randint(1, 12, (4, 6)).astype(np.int32)
    tgt[:, 4:] = padding_value
    tgt[1, 2] = padding_value
    jin = jnn.ClassNLLCriterion() if inner == "nll" else jnn.MSECriterion()
    tin = tnn.ClassNLLCriterion() if inner == "nll" else tnn.MSECriterion()
    jc = jnn.TimeDistributedMaskCriterion(jin, padding_value)
    tc = tnn.TimeDistributedMaskCriterion(tin, padding_value)
    lj, gj = jax.value_and_grad(lambda o: jc(o, jnp.asarray(tgt)))(
        jnp.asarray(out))
    ot = torch.from_numpy(np.array(out)).requires_grad_()
    lt = tc(ot, torch.from_numpy(tgt))
    lt.backward()
    assert abs(float(lt.detach()) - float(lj)) <= 1e-6 * abs(float(lj))
    np.testing.assert_allclose(ot.grad.numpy(), np.asarray(gj), atol=1e-7,
                               rtol=0)
    assert np.all(ot.grad.numpy()[tgt == padding_value] == 0)


# --------------------------------------------------------------------------
# The FLOP count, the benchmark and the example
# --------------------------------------------------------------------------

def test_ptb_step_flops_on_the_meta_device():
    """`count_flops` of a bf16 PTB training step on the meta device: the
    gate products and the output projection, forward (2 B T (L 8 H^2 + H
    V)) and backward (twice that, less the zero state's gradient, which
    autograd skips: 2 B H 4H a layer), and nothing for the lookup, the
    gates' elementwise work and LogSoftMax; the same count as the step
    run on the CPU."""
    model = tmodels.PTBModel(101, HIDDEN, 101, device="cpu")
    x, y = bench._ptb_batch(101, STEPS, B)
    opt = bench._resident_optimizer(
        model, x, y, tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion()),
        torch.device("cpu"))
    layers, h, v = 2, HIDDEN, 101
    fwd = 2 * B * STEPS * (layers * 8 * h * h + h * v)
    want = 3 * fwd - layers * 2 * B * h * 4 * h
    assert bench.step_flops(opt) == want
    params = dict(model.named_parameters())
    opt_state = opt.optim_method.init_state_with_masters(params)
    cpu = costs.count_flops(opt._build_step(), opt_state, torch.from_numpy(x),
                            torch.from_numpy(y), 0.01)
    assert cpu == want


def test_bench_ptb_lstm_on_the_cpu():
    res = bench.bench_ptb_lstm(batch_size=2, seq=5, vocab=61, hidden=8,
                               warmup=2, iters=2, sync=2, device="cpu")
    assert res["model"] == "ptb_lstm" and res["steps"] == 4
    assert res["tokens_per_sec"] == pytest.approx(5 * res["records_per_sec"])
    assert len(res["losses"]) == 4 and np.all(np.isfinite(res["losses"]))
    assert res["flops_per_step"] > 0 and res["mfu"] is None
    # the first loss: 5 steps of about ln(61) each, summed over T
    assert abs(res["losses"][0] - 5 * np.log(61)) < 0.5


def test_language_model_example_learns_the_corpus():
    from bigdl_tpu_torch.tools import language_model
    ppl = language_model.main(["--device", "cpu", "--max-epoch", "1"])
    assert ppl < 200  # chance is about the vocabulary's size
    x, y = language_model.batchify(np.arange(41, dtype=np.int32), 20)
    assert x.shape == y.shape == (2, 20) and x.dtype == np.float32
    assert x[0, 0] == 1 and y[0, 0] == 2  # 1-based, next-token targets


# --------------------------------------------------------------------------
# The rest of the file: peephole, GRU, convolutional cells, BiRecurrent,
# RecurrentDecoder (held as above: atol 1e-5 on outputs and the input's
# gradient, 1e-4 of each tensor's largest element on parameter gradients)
# --------------------------------------------------------------------------

#: kind -> (JAX Recurrent, port Recurrent, input shape [B, T, ...])
NEW_RECURRENT = {
    "peephole": (lambda: jnn.Recurrent(jnn.LSTMPeepholeCell(3, 5)),
                 lambda: tnn.Recurrent(tnn.LSTMPeepholeCell(3, 5,
                                                            device="cpu")),
                 (2, 4, 3)),
    "peephole_alias_last": (
        lambda: jnn.Recurrent(jnn.LSTMPeephole(3, 5), False, True),
        lambda: tnn.Recurrent(tnn.LSTMPeephole(3, 5, device="cpu"), False,
                              True), (2, 4, 3)),
    "gru": (lambda: jnn.Recurrent(jnn.GRUCell(3, 5)),
            lambda: tnn.Recurrent(tnn.GRUCell(3, 5, device="cpu")),
            (2, 4, 3)),
    "gru_alias_reverse": (
        lambda: jnn.Recurrent(jnn.GRU(3, 5), True, True),
        lambda: tnn.Recurrent(tnn.GRU(3, 5, device="cpu"), True, True),
        (2, 4, 3)),
    "gru_in_a_stack": (
        lambda: jnn.Recurrent(jnn.MultiRNNCell([jnn.GRUCell(3, 4),
                                                jnn.LSTMPeepholeCell(4, 5)])),
        lambda: tnn.Recurrent(tnn.MultiRNNCell([
            tnn.GRUCell(3, 4, device="cpu"),
            tnn.LSTMPeepholeCell(4, 5, device="cpu")])), (2, 4, 3)),
    "conv_lstm": (lambda: jnn.Recurrent(jnn.ConvLSTMPeephole(2, 3)),
                  lambda: tnn.Recurrent(tnn.ConvLSTMPeephole(2, 3,
                                                             device="cpu")),
                  (2, 3, 5, 5, 2)),
    "conv_lstm_no_peephole_k5": (
        lambda: jnn.Recurrent(jnn.ConvLSTMPeephole(2, 3, 5, 3, 1, False)),
        lambda: tnn.Recurrent(tnn.ConvLSTMPeephole(2, 3, 5, 3, 1, False,
                                                   device="cpu")),
        (2, 3, 5, 5, 2)),
    "conv_lstm_3d": (lambda: jnn.Recurrent(jnn.ConvLSTMPeephole3D(2, 3)),
                     lambda: tnn.Recurrent(tnn.ConvLSTMPeephole3D(
                         2, 3, device="cpu")), (1, 3, 4, 4, 4, 2)),
}


def _nonzero_peepholes(params):
    """The conv cells init their bias and peepholes at zero: give them
    values so the test sees them."""
    rs = np.random.RandomState(11)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else (
            (rs.randn(*v.shape) * 0.3).astype(np.float32)
            if k.startswith("peep") or k == "bias" else v)
            for k, v in t.items()}
    return walk(params)


@pytest.mark.parametrize("kind", sorted(NEW_RECURRENT))
def test_new_cells_in_recurrent_match_the_reference(kind):
    jf, tf, shape = NEW_RECURRENT[kind]
    jm, tm = jf(), tf()
    params = _nonzero_peepholes(_np(jm.init(jax.random.PRNGKey(2))))
    load_module_params(tm, params)
    assert set(dict(tm.named_parameters())) == {
        ".".join(p) for p in _paths(params)}
    _check(jm, tm, _x(*shape, seed=8), params)


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def test_gru_is_the_reference_s_variant_not_torch_s():
    """The port's GRU applies the reset gate before its hidden product, as
    the reference's (Cho et al.): it matches the JAX GRU, and the same
    weights in `torch.nn.GRU`'s formulation, r * (h @ W_hn + b_hn), do not
    (their gap is far above the tolerance)."""
    jm = jnn.Recurrent(jnn.GRUCell(3, 4))
    tm = tnn.Recurrent(tnn.GRUCell(3, 4, device="cpu"))
    params = _np(jm.init(jax.random.PRNGKey(6)))
    load_module_params(tm, params)
    x = _x(2, 6, 3, seed=6)
    got = _check(jm, tm, x, params)
    p = params["cell"]
    tg = torch.nn.GRU(3, 4, batch_first=True)
    with torch.no_grad():
        # torch's gate order r, z, n; weights [3h, in]; h @ W_hn + b_hn
        # inside r's product, b_n as the input bias, b_hn = 0
        tg.weight_ih_l0.copy_(torch.from_numpy(np.concatenate(
            [p["wi_rz"], p["wi_n"]], 1).T))
        tg.weight_hh_l0.copy_(torch.from_numpy(np.concatenate(
            [p["wh_rz"], p["wh_n"]], 1).T))
        tg.bias_ih_l0.copy_(torch.from_numpy(np.concatenate(
            [p["b_rz"], p["b_n"]])))
        tg.bias_hh_l0.zero_()
        torch_variant, _ = tg(torch.from_numpy(x))
    gap = float(np.abs(torch_variant.numpy() - got).max())
    assert gap > 100 * ATOL


@pytest.mark.parametrize("merge", ["concat", "sum", "mul", "ave"])
def test_birecurrent_merges_match_the_reference(merge):
    jm = jnn.BiRecurrent(jnn.LSTMCell(3, 4), None, merge)
    tm = tnn.BiRecurrent(tnn.LSTMCell(3, 4, device="cpu"), None, merge)
    params = _np(jm.init(jax.random.PRNGKey(4)))
    assert set(params) == {"fwd", "bwd"}
    load_module_params(tm, params)
    out = _check(jm, tm, _x(2, 5, 3, seed=3), params)
    assert out.shape == ((2, 5, 8) if merge == "concat" else (2, 5, 4))


def test_birecurrent_with_its_own_backward_cell():
    jm = jnn.BiRecurrent(jnn.GRUCell(3, 4), jnn.LSTMPeepholeCell(3, 4),
                         "sum")
    tm = tnn.BiRecurrent(tnn.GRUCell(3, 4, device="cpu"),
                         tnn.LSTMPeepholeCell(3, 4, device="cpu"), "sum")
    params = _np(jm.init(jax.random.PRNGKey(5)))
    load_module_params(tm, params)
    _check(jm, tm, _x(2, 5, 3, seed=4), params)


def test_birecurrent_draws_a_fresh_backward_cell():
    """Without `cell_bwd` the backward half is a copy of the forward cell
    with parameters of its own (the reference inits the copy from its
    own key); an unknown merge raises the reference's ValueError."""
    cell = tnn.LSTMCell(3, 4, device="cpu")
    bi = tnn.BiRecurrent(cell, generator=torch.Generator().manual_seed(7))
    assert bi.fwd.cell is cell and type(bi.bwd.cell) is tnn.LSTMCell
    assert bi.bwd.reverse and not bi.fwd.reverse
    for (na, a), (nb, b) in zip(bi.fwd.named_parameters(),
                                bi.bwd.named_parameters()):
        assert na == nb and a.shape == b.shape and not torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown merge"):
        tnn.BiRecurrent(cell, None, "max")(torch.zeros(1, 2, 3))


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_recurrent_decoder_matches_the_reference(cell):
    make = {"lstm": lambda pkg, kw: pkg.LSTMCell(5, 5, **kw),
            "gru": lambda pkg, kw: pkg.GRUCell(5, 5, **kw)}[cell]
    jm = jnn.RecurrentDecoder(make(jnn, {}), 4)
    tm = tnn.RecurrentDecoder(make(tnn, {"device": "cpu"}), 4)
    params = _np(jm.init(jax.random.PRNGKey(7)))
    load_module_params(tm, params)
    out = _check(jm, tm, _x(3, 5, seed=5), params)
    assert out.shape == (3, 4, 5)


@pytest.mark.parametrize("kind", ["peephole", "gru", "conv_lstm"])
def test_new_cell_single_step_through_a_table(kind):
    """forward(T(x, state)) -> T(out, new_state), as the reference's
    apply."""
    make = {"peephole": lambda pkg, kw: pkg.LSTMPeepholeCell(3, 5, **kw),
            "gru": lambda pkg, kw: pkg.GRUCell(3, 5, **kw),
            "conv_lstm": lambda pkg, kw: pkg.ConvLSTMPeephole(3, 5, **kw)}
    jc, tc = make[kind](jnn, {}), make[kind](tnn, {"device": "cpu"})
    params = _nonzero_peepholes(_np(jc.init(jax.random.PRNGKey(8))))
    load_module_params(tc, params)
    lead = (2, 4, 4) if kind == "conv_lstm" else (2,)
    x = _x(*lead, 3, seed=9)
    h = _x(*lead, 5, seed=10)
    state = h if kind == "gru" else (h, _x(*lead, 5, seed=11))
    jstate = jax.tree_util.tree_map(jnp.asarray, state)
    tstate = jax.tree_util.tree_map(torch.from_numpy, state)
    out_j, _ = functional_apply(jc, params, JT(jnp.asarray(x), jstate))
    out_t = tc(T(torch.from_numpy(x), tstate))
    np.testing.assert_allclose(out_t[1].detach().numpy(),
                               np.asarray(out_j[1]), atol=ATOL, rtol=0)
    got_s = jax.tree_util.tree_map(lambda t: t.detach().numpy(), out_t[2])
    _close_tree(got_s, _np(out_j[2]), rtol=ATOL)


def test_cells_reset_their_parameters_from_a_generator():
    """`reset_parameters(g)` redraws every leaf with the constructor's
    shapes; the same seed gives the same leaves."""
    for make in (lambda: tnn.GRUCell(3, 4, device="cpu"),
                 lambda: tnn.LSTMPeepholeCell(3, 4, device="cpu"),
                 lambda: tnn.ConvLSTMPeephole3D(2, 3, device="cpu"),
                 lambda: tnn.MultiRNNCell([tnn.RnnCell(3, 4, device="cpu"),
                                           tnn.LSTMCell(4, 4,
                                                        device="cpu")])):
        a, b = make(), make()
        a.reset_parameters(torch.Generator().manual_seed(3))
        b.reset_parameters(torch.Generator().manual_seed(3))
        for (n, pa), (_, pb) in zip(a.named_parameters(),
                                    b.named_parameters()):
            assert torch.equal(pa, pb), n
        assert [p.shape for p in a.parameters()] == \
            [p.shape for p in make().parameters()]


def test_conv_lstm_refuses_a_stride():
    with pytest.raises(NotImplementedError, match="stride"):
        tnn.ConvLSTMPeephole(2, 3, 3, 3, 2, device="cpu")
