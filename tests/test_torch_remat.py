"""Port parity: `bigdl_tpu_torch.nn.Remat` and `ResNet(remat=True)`
against `bigdl_tpu`, and `Remat` against the port's own twin without it.

The reference's `Remat` is `jax.checkpoint` over a pure function; the
port's re-runs modules under `torch.utils.checkpoint`, so three traps a
plain checkpoint falls into are held here: BN's running statistics must
move once a step, not twice; a dropout mask must be drawn the same in the
recompute, and the lent generator left as the twin leaves it; and the
recompute must run with the parameters the forward used (the loops'
bf16 copies). `_PlainCheckpoint` below is such a plain wrapper: the same
checks fail through it (`test_a_plain_checkpoint_falls_into_the_traps`).

Inputs and weights come from numpy with fixed seeds, the JAX weights
carried into the port (`interop.load_module_params`), never initialised
anew. Tolerances, f32 (tests/conftest.py sets JAX's matmul precision to
"highest"): losses within a relative 1e-5 and gradients within 1e-4 of
their tensor's largest element, or 1e-6 (the reference's own atol) where
that is smaller (a conv bias before a BN has a gradient of zero in exact
arithmetic, rounding noise of ~1e-7 in both), against JAX (the same
products summed in another order by oneDNN and XLA); BN statistics
within 1e-5. Against the
port's twin without `Remat`, on the CPU: bit for bit (the same ops on the
same inputs).
"""

import copy

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
from bigdl_tpu.models.resnet import ResNet as JResNet
from bigdl_tpu.nn.module import functional_apply as jfunctional_apply
from bigdl_tpu.serialization.module_serializer import ModuleSerializer as JS
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.interop import (load_module_params, module_params_tree,
                                     module_state)
from bigdl_tpu_torch.models import ResNet as TResNet
from bigdl_tpu_torch.nn import lend_generator
from bigdl_tpu_torch.observability import costs
from bigdl_tpu_torch.serialization import ModuleSerializer

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-6
STAT_ATOL = 1e-5
CPU = {"device": "cpu"}


@pytest.fixture
def one_thread():
    """One torch thread for the whole-model cases (JAX runs beside torch
    in this file; see tests/test_torch_recurrent.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _np(tree):
    return {k: _np(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else np.asarray(tree)


def _close_tree(got, want, rel=GRAD_RTOL, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _close_tree(got[k], want[k], rel, f"{path}.{k}")
            continue
        b = np.asarray(want[k])
        np.testing.assert_allclose(
            got[k], b, rtol=0,
            atol=max(rel * float(np.abs(b).max()), GRAD_ATOL),
            err_msg=f"{path}.{k}")


class _PlainCheckpoint(tnn.Container):
    """What `Remat` is not: the child under a bare
    `torch.utils.checkpoint.checkpoint`."""

    def __init__(self, module, name=None):
        super().__init__(name)
        self.add(module)

    def forward(self, x):
        return checkpoint(self.children_in_order()[0], x,
                          use_reentrant=False)


def _conv_bn_relu(pkg, **kw):
    return (pkg.Sequential()
            .add(pkg.SpatialConvolution(3, 4, 3, 3, pad_w=1, pad_h=1, **kw))
            .add(pkg.SpatialBatchNormalization(4, **kw)).add(pkg.ReLU()))


def _wrapped(pkg, inner, wrap, **kw):
    return (pkg.Sequential().add(wrap(inner) if wrap else inner)
            .add(pkg.Reshape((4 * 8 * 8,)))
            .add(pkg.Linear(4 * 8 * 8, 2, **kw)))


# --------------------------------------------------------------------------
# The reference's TestRemat cases, against JAX
# --------------------------------------------------------------------------

def test_matches_the_reference_remat_with_bn_and_grads():
    """The reference's `test_matches_unwrapped_with_bn_and_grads`: loss,
    gradients and the new BN state (under the Remat level's path) of
    `Remat(conv -> BN -> ReLU)` against JAX's `Remat`."""
    x = np.random.RandomState(0).randn(4, 8, 8, 3).astype(np.float32)
    jm = _wrapped(jnn, _conv_bn_relu(jnn), jnn.Remat)
    tm = _wrapped(tnn, _conv_bn_relu(tnn, **CPU), tnn.Remat, **CPU)
    params = _np(jm.init(jax.random.PRNGKey(0)))
    state = jm.state_init()
    assert any("Remat" in k[0] for k in state)
    load_module_params(tm, params, _np(state))

    def f(p):
        out, ns = jfunctional_apply(jm, p, jnp.asarray(x), state=state,
                                    training=True)
        return jnp.sum(out ** 2), ns
    (loss_j, new_j), grads_j = jax.value_and_grad(f, has_aux=True)(params)
    out = tm.train()(torch.from_numpy(x))
    loss = (out ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                               rtol=LOSS_RTOL)
    _close_tree(module_params_tree(tm, grad=True), _np(grads_j))
    got = module_state(tm)
    assert set(got) == set(new_j)
    for path, stats in new_j.items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(got[path][k], np.asarray(stats[k]),
                                       atol=STAT_ATOL, rtol=0)


def test_dropout_is_deterministic_per_generator():
    """The reference's `test_remat_dropout_deterministic_per_rng`: the same
    generator seed, the same output."""
    m = tnn.Sequential().add(tnn.Remat(
        tnn.Sequential().add(tnn.Linear(6, 6, **CPU)).add(tnn.Dropout(0.5))))
    x = torch.ones(8, 6)
    outs = []
    for _ in range(2):
        with lend_generator(torch.Generator().manual_seed(3)):
            outs.append(m.train()(x))
    assert torch.equal(outs[0], outs[1])


# --------------------------------------------------------------------------
# Against the port's twin without Remat: the traps
# --------------------------------------------------------------------------

def _bn_step(model, x):
    out = model.train()(x)
    (out ** 2).sum().backward()
    return out.detach(), {k: v.clone() for k, v in model.state_dict().items()
                          if k.endswith(("mean", "var"))}


def test_bn_running_statistics_move_once_a_step():
    x = torch.from_numpy(np.random.RandomState(1).randn(4, 8, 8, 3)
                         .astype(np.float32))
    twin = _wrapped(tnn, _conv_bn_relu(tnn, **CPU), None, **CPU)
    remat = _wrapped(tnn, copy.deepcopy(twin.children_in_order()[0]),
                     tnn.Remat, **CPU)
    remat.children_in_order()[2].load_state_dict(
        twin.children_in_order()[2].state_dict())
    out_t, stats_t = _bn_step(twin, x)
    out_r, stats_r = _bn_step(remat, x)
    assert torch.equal(out_t, out_r)
    assert len(stats_t) == len(stats_r) == 2
    for (kt, a), (kr, b) in zip(stats_t.items(), stats_r.items()):
        assert kr.split(".", 2)[-1] == kt.split(".", 1)[-1]
        assert torch.equal(a, b), kr
    for (n, p), (_, q) in zip(twin.named_parameters(),
                              remat.named_parameters()):
        assert torch.equal(p.grad, q.grad), n


def _dropout_step(model, x, seed=5):
    """One step under one lent generator, the backward inside the lend
    (as the loops run it); (output, gradients, the generator's state
    after the step)."""
    gen = torch.Generator().manual_seed(seed)
    with lend_generator(gen):
        out = model.train()(x)
        (out * torch.arange(out.numel()).reshape(out.shape)).sum() \
            .backward()
        torch.rand(3, generator=gen)  # a later draw in the same step
    return out.detach(), [p.grad.clone() for p in model.parameters()], \
        gen.get_state()


def _linear_dropout(wrap):
    inner = (tnn.Sequential()
             .add(tnn.Linear(6, 6, **CPU,
                             generator=torch.Generator().manual_seed(2)))
             .add(tnn.Dropout(0.5)))
    return tnn.Sequential().add(wrap(inner) if wrap else inner).add(
        tnn.Dropout(0.3))


def test_dropout_mask_and_generator_state_equal_the_twin_s():
    x = torch.from_numpy(np.random.RandomState(2).randn(8, 6)
                         .astype(np.float32))
    out_t, grads_t, state_t = _dropout_step(_linear_dropout(None), x)
    out_r, grads_r, state_r = _dropout_step(_linear_dropout(tnn.Remat), x)
    assert torch.equal(out_t, out_r)
    assert all(torch.equal(a, b) for a, b in zip(grads_t, grads_r))
    assert torch.equal(state_t, state_r)


def test_a_plain_checkpoint_falls_into_the_traps():
    """The checks above fail through a bare checkpoint wrapper: BN's
    statistics move twice, and the recompute draws another mask and
    leaves the generator elsewhere."""
    x = torch.from_numpy(np.random.RandomState(1).randn(4, 8, 8, 3)
                         .astype(np.float32))
    twin = _wrapped(tnn, _conv_bn_relu(tnn, **CPU), None, **CPU)
    plain = _wrapped(tnn, copy.deepcopy(twin.children_in_order()[0]),
                     _PlainCheckpoint, **CPU)
    plain.children_in_order()[2].load_state_dict(
        twin.children_in_order()[2].state_dict())
    _, stats_t = _bn_step(twin, x)
    _, stats_p = _bn_step(plain, x)
    assert not all(torch.equal(a, b)
                   for a, b in zip(stats_t.values(), stats_p.values()))
    x = torch.from_numpy(np.random.RandomState(2).randn(8, 6)
                         .astype(np.float32))
    _, grads_t, state_t = _dropout_step(_linear_dropout(None), x)
    _, grads_p, state_p = _dropout_step(_linear_dropout(_PlainCheckpoint),
                                        x)
    assert not torch.equal(state_t, state_p)
    assert not all(torch.equal(a, b) for a, b in zip(grads_t, grads_p))


def test_eval_and_no_grad_run_the_child_once():
    """Training with grad: the child runs twice a step (the forward and
    the recompute); eval mode or no grad: once, no checkpoint."""
    calls = []

    class Probe(tnn.Identity):
        def forward(self, x):
            calls.append(1)
            return torch.tanh(x)  # saves its output: the recompute runs it

    m = tnn.Remat(tnn.Sequential().add(tnn.Linear(3, 3, **CPU)).add(Probe()))
    x = torch.ones(2, 3)
    m.train()(x).sum().backward()
    assert len(calls) == 2
    calls.clear()
    with torch.no_grad():
        m.train()(x)
    m.eval()(x)
    assert len(calls) == 2


def test_the_recompute_uses_the_forward_s_parameters():
    """A bf16 step through the loop (`set_compute_precision("bfloat16")`:
    the forward runs on bf16 copies of the f32 parameters, gone from the
    modules when the backward recomputes) equals the twin's, bit for
    bit, over 2 SGD steps: parameters and BN statistics."""
    from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, max_iteration
    rs = np.random.RandomState(3)
    x = rs.rand(4, 32, 32, 3).astype(np.float32)
    y = (rs.randint(0, 4, size=4) + 1).astype(np.int32)
    models = [TResNet(4, depth=18, remat=remat, **CPU,
                      generator=torch.Generator().manual_seed(0))
              for remat in (False, True)]
    for m in models:
        opt = LocalOptimizer(m, LocalDataSet([MiniBatch(x, y)]),
                             tnn.ClassNLLCriterion(), **CPU)
        opt.set_optim_method(SGD(learning_rate=0.1, momentum=0.9))
        opt.set_compute_precision("bfloat16")
        opt.set_end_when(max_iteration(2))
        opt.optimize()
    twin, remat = (module_params_tree(m) for m in models)
    got, want = _flat(_strip_remat(remat)), _flat(twin)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    st_t = module_state(models[0])
    st_r = {_twin_path(p): v for p, v in module_state(models[1]).items()}
    assert st_r.keys() == st_t.keys()
    for path in st_t:
        for k in ("mean", "var"):
            assert np.array_equal(st_r[path][k], st_t[path][k]), path


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _twin_path(path):
    """A state path of a remat ResNet as its twin's: "<i>_Remat",
    "0_Sequential" -> "<i>_Sequential"."""
    if path[0].endswith("_Remat"):
        return (path[0][:-len("Remat")] + "Sequential",) + path[2:]
    return path


def test_flop_count_on_the_meta_device_includes_the_recompute():
    """A training step counted on the meta device runs with the checkpoint
    inside. The count includes the recompute: the twin's FLOPs plus one
    more forward of the wrapped child (the reference's executable cost
    counts its recompute too)."""
    x = torch.empty(4, 8, 8, 3, device="meta")
    inner = _conv_bn_relu(tnn, device="meta")

    def step(model):
        def run():
            model.train()(x).sum().backward()
        return costs.count_flops(run)
    twin = _wrapped(tnn, copy.deepcopy(inner), None, device="meta")
    remat = _wrapped(tnn, copy.deepcopy(inner), tnn.Remat, device="meta")
    child = copy.deepcopy(inner)
    with torch.no_grad():
        child_fwd = costs.count_flops(lambda: child.train()(x))
    assert child_fwd > 0
    assert step(remat) == step(twin) + child_fwd


# --------------------------------------------------------------------------
# ResNet(remat=True)
# --------------------------------------------------------------------------

def _strip_remat(tree):
    """A remat ResNet's tree with each "<i>_Remat": {"0_Sequential": t}
    level as "<i>_Sequential": t, the twin's keys."""
    out = {}
    for k, v in tree.items():
        if k.endswith("_Remat"):
            out[k[:-len("Remat")] + "Sequential"] = v["0_Sequential"]
        else:
            out[k] = v
    return out


def test_resnet_remat_tree_is_the_twin_s_with_a_remat_level():
    plain = TResNet(4, depth=18, s2d_stem=True, **CPU)
    remat = TResNet(4, depth=18, s2d_stem=True, remat=True, **CPU)
    assert sum(p.numel() for p in plain.parameters()) == \
        sum(p.numel() for p in remat.parameters())
    tp, tr = module_params_tree(plain), module_params_tree(remat)
    assert sum(k.endswith("_Remat") for k in tr) == 8
    shapes = lambda t: {k: shapes(v) if isinstance(v, dict) else v.shape
                        for k, v in t.items()}
    assert shapes(_strip_remat(tr)) == shapes(tp)
    # the CIFAR branch returns before it reads remat, as the reference's
    cifar = TResNet(10, depth=8, data_set="cifar10", remat=True, **CPU)
    assert not any(isinstance(m, tnn.Remat) for m in cifar.modules())


def test_resnet18_remat_training_step_matches_the_reference(one_thread):
    """`ResNet(4, depth=18, s2d_stem=True, remat=True)` at 64x64, b2: one
    training step (loss, gradients, the new BN state, an SGD update at lr
    0.1) against the JAX model's."""
    rs = np.random.RandomState(4)
    x = rs.randn(2, 64, 64, 3).astype(np.float32)
    w = rs.randn(2, 4).astype(np.float32)
    jm = JResNet(4, depth=18, s2d_stem=True, remat=True)
    tm = TResNet(4, depth=18, s2d_stem=True, remat=True, **CPU)
    # nonzero residual gammas, so every block's branch carries a gradient
    params = _nonzero_gammas(_np(jm.ensure_params()))
    state = jm._state
    load_module_params(tm, params, _np(state))

    def f(p):
        out, ns = jfunctional_apply(jm, p, jnp.asarray(x), state=state,
                                    training=True)
        return jnp.sum(out * w), ns
    (loss_j, new_j), grads_j = jax.jit(jax.value_and_grad(
        f, has_aux=True))(params)
    out = tm.train()(torch.from_numpy(x))
    loss = (out * torch.from_numpy(w)).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                               rtol=LOSS_RTOL)
    grads_j = _np(grads_j)
    _close_tree(module_params_tree(tm, grad=True), grads_j)
    got = module_state(tm)
    assert set(got) == set(new_j) and any(
        "0_Sequential" in p and p[0].endswith("_Remat") for p in got)
    for path, stats in new_j.items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(got[path][k], np.asarray(stats[k]),
                                       atol=STAT_ATOL, rtol=0)
    with torch.no_grad():
        for p in tm.parameters():
            p -= 0.1 * p.grad
    _close_tree(module_params_tree(tm), _sgd(params, grads_j, 0.1))


def _nonzero_gammas(tree, rs=None):
    """The zero-initialised BN gammas (`zero_gamma`, each block's last BN)
    drawn from U(0.05, 0.15): at 0 they leave the residual branches
    without a gradient."""
    rs = rs or np.random.RandomState(0)
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _nonzero_gammas(v, rs)
        elif k == "weight" and v.ndim == 1 and not v.any():
            out[k] = (rs.rand(*v.shape) * 0.1 + 0.05).astype(np.float32)
        else:
            out[k] = v
    return out


def _sgd(params, grads, lr):
    if isinstance(params, dict):
        return {k: _sgd(params[k], grads[k], lr) for k in params}
    return params - lr * grads


def test_remat_resnet_launch_counts_on_the_cpu(monkeypatch):
    """The fused BN+ReLU tail's calls in one training step of ResNet-18
    (9 sites: the stem's and one a basic block): with remat the forward
    runs 9 + 8 times (the 8 in-block sites again in the recompute) and the
    backward 9; without, 9 and 9. The card's kernel 6/7 launches follow
    these calls one for one."""
    from bigdl_tpu_torch.ops import bn_relu_kernel as tbk
    counts = {}
    for remat in (True, False):
        calls = {"fwd": 0, "bwd": 0}
        fwd, bwd = tbk.bn_relu_forward, tbk.bn_relu_backward

        def counted(fn, key):
            def wrapper(*a, **k):
                calls[key] += 1
                return fn(*a, **k)
            return wrapper
        monkeypatch.setattr(tbk, "bn_relu_forward", counted(fwd, "fwd"))
        monkeypatch.setattr(tbk, "bn_relu_backward", counted(bwd, "bwd"))
        m = TResNet(4, depth=18, remat=remat, **CPU)
        m.train()(torch.rand(2, 32, 32, 3)).sum().backward()
        monkeypatch.undo()
        counts[remat] = calls
    assert counts == {True: {"fwd": 17, "bwd": 9},
                      False: {"fwd": 9, "bwd": 9}}


def test_remat_resnet_serves_as_the_twin():
    """Inference conversion sees through `Remat`: the remat ResNet's BNs
    fold as the twin's, and the served rows are the twin's bit for
    bit."""
    from bigdl_tpu_torch.ir import ConversionUtils
    g = torch.Generator().manual_seed(1)
    twin = TResNet(4, depth=18, **CPU, generator=g)
    remat = TResNet(4, depth=18, remat=True, **CPU,
                    generator=torch.Generator().manual_seed(1))
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(2))
    outs = []
    for m in (twin, remat):
        conv = ConversionUtils.convert(copy.deepcopy(m).eval())
        assert not any(isinstance(c, tnn.BatchNormalization)
                       for c in conv.modules())
        with torch.no_grad():
            outs.append(conv(x))
    assert torch.equal(outs[0], outs[1])


# --------------------------------------------------------------------------
# Model files
# --------------------------------------------------------------------------

def _remat_model(pkg, **kw):
    return pkg.Sequential().add(pkg.Remat(
        pkg.Sequential().add(pkg.Linear(4, 3, **kw))
        .add(pkg.BatchNormalization(3, **kw)).add(pkg.Tanh())))


def test_a_remat_file_crosses_between_the_packages(tmp_path):
    """A `Remat` model file written by each package is read by the other:
    the tree (the Remat level included), the BN state, and the eval
    forward within 1e-6."""
    x = np.random.RandomState(5).randn(5, 4).astype(np.float32)
    tm = _remat_model(tnn, **CPU)
    with torch.no_grad():
        bn = tm.children_in_order()[0].children_in_order()[0] \
            .children_in_order()[1]
        bn.mean.copy_(torch.tensor([0.1, -0.2, 0.3]))
        bn.var.copy_(torch.tensor([1.5, 0.5, 2.0]))
    want = tm.eval()(torch.from_numpy(x)).detach().numpy()
    port_file = str(tmp_path / "t.bigdl")
    ModuleSerializer.save(tm, port_file)
    jm = JS.load(port_file)
    assert type(jm.children[0]).__name__ == "Remat"
    got = np.asarray(jm.forward(jnp.asarray(x), training=False))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    jax_file = str(tmp_path / "j.bigdl")
    JS.save(jm, jax_file)
    back = ModuleSerializer.load(jax_file, device="cpu")
    assert isinstance(back.children_in_order()[0], tnn.Remat)
    assert module_state(back).keys() == module_state(tm).keys()
    np.testing.assert_allclose(
        back.eval()(torch.from_numpy(x)).detach().numpy(), want, atol=1e-6,
        rtol=0)
