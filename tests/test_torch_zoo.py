"""Port parity: the feed-forward model zoo of `bigdl_tpu_torch` (LeNet-5,
Inception v1 and v2, VGG, the autoencoder) and its new layers against
`bigdl_tpu`, with the JAX model's parameters and BN state carried into the
port (`interop.load_module_params`), never initialised anew.

Inputs come from numpy with fixed seeds. Single layers compare outputs and
the gradients of `sum(out * w)` (a random `w`) with respect to the input
and the parameters, against `jax.value_and_grad` of the reference layer.
The blocks and whole models take 3 SGD steps (momentum 0.9) through the
port's `DistriOptimizer`, against the reference's `SGD.update` over
`jax.value_and_grad` of the same loss; the loss, every parameter and the
BN running statistics are compared after each step.

Tolerances, all in f32 (tests/conftest.py sets JAX's matmul precision to
"highest"):
- single layers: atol 1e-5 on outputs and gradients (the same arithmetic,
  summed in another order by oneDNN and XLA); LRN and the pools: 1e-5;
- trajectories: losses within a relative 1e-5 (blocks) or 1e-4 (whole
  models), each parameter and BN statistic within 1e-4 of the largest
  element of its tensor (thousands of f32 terms per convolution, summed in
  other orders and carried through three momentum steps), and never below
  1e-6 (`REL_FLOOR`: a bias before a BN has a zero gradient, so it moves
  by rounding noise only);
- `Dropout` is held by its statistics only: the port draws its bits from a
  `torch.Generator`, the reference from a JAX key;
- the full-depth builders' parameter trees (keys, shapes, count) equal
  those of the JAX model's `init`, taken with `jax.eval_shape`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.models import autoencoder as jae
from bigdl_tpu.models import inception as jinc
from bigdl_tpu.models import lenet as jlenet
from bigdl_tpu.models import vgg as jvgg
from bigdl_tpu.nn.module import functional_apply, merge_state
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch import models as tmodels
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
from bigdl_tpu_torch.interop import (load_module_params, module_params_tree,
                                     module_state)
from bigdl_tpu_torch.interop.jax_params import _bn_modules, _module_targets
from bigdl_tpu_torch.observability import costs
from bigdl_tpu_torch.ops import bn_relu_kernel as tbk
from bigdl_tpu_torch.tools import bench

ATOL = 1e-5
#: the absolute floor of the relative comparisons: a convolution's bias
#: before a BN has a zero gradient in exact arithmetic, so both packages
#: move it by f32 rounding noise (1e-9 to 1e-7 a step here)
REL_FLOOR = 1e-6


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _np_copy(tree):
    return jax.tree_util.tree_map(np.copy, tree)


def _x(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _init(jmod, seed=1, jit=False):
    """The JAX module's `init`; with `jit`, one compile instead of one per
    op (quicker for a whole model, slower for a block), the reference's
    fan computation kept concrete by `ensure_compile_time_eval`."""
    key = jax.random.PRNGKey(seed)
    if not jit:
        return _np(jmod.init(key))
    with jax.ensure_compile_time_eval():
        return _np(jax.jit(jmod.init)(key))


def _carry(jmod, tmod, seed=1, jit=False):
    """The JAX module's params and BN state, loaded into the port's."""
    params = _init(jmod, seed, jit)
    state = {k: _np(v) for k, v in (jmod.state_init() or {}).items()} \
        if hasattr(jmod, "state_init") else {}
    load_module_params(tmod, params, state or None)
    return params, state


def _check_layer(jmod, tmod, x, atol=ATOL):
    """Output, d/dx and d/dparams of sum(out * w), training mode."""
    params, state = _carry(jmod, tmod)
    out0, _ = functional_apply(jmod, params, jnp.asarray(x), state=state,
                               training=True)
    w = np.random.RandomState(9).randn(*np.shape(out0)).astype(np.float32)

    def f(p, xx):
        out, _ = functional_apply(jmod, p, xx, state=state, training=True)
        return jnp.sum(out * w), out
    (_, out_j), (gp_j, gx_j) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    tmod.train()
    xt = torch.from_numpy(x).requires_grad_()
    out_t = tmod(xt)
    (out_t * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=atol, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), atol=atol,
                               rtol=0)
    if jax.tree_util.tree_leaves(params):
        _assert_trees_close(module_params_tree(tmod, grad=True), _np(gp_j),
                            atol=atol)
    return out_t.detach().numpy()


def _assert_trees_close(got, want, atol=None, rel=None, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_close(got[k], want[k], atol, rel, f"{path}.{k}")
            continue
        tol = atol if rel is None else max(rel * np.abs(want[k]).max(),
                                           REL_FLOOR)
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0,
                                   err_msg=f"{path}.{k}")


# ------------------------------------------------------------ the layers

@pytest.mark.parametrize("name", ["Tanh", "Sigmoid"])
def test_activation(name):
    _check_layer(getattr(jnn, name)(), getattr(tnn, name)(),
                 _x(4, 6, 5, scale=2.0))


def test_reshape_flattens_nhwc_in_the_reference_order():
    """conv -> Reshape -> Linear: the Linear weight is laid out for the
    (H, W, C) order, which the port's Reshape keeps. Flattening the
    channels_last NCHW view the convolution runs on would give (C, H, W)
    order: the same numbers, permuted."""
    j = (jnn.Sequential().add(jnn.SpatialConvolution(2, 3, 3, 3))
         .add(jnn.Reshape((3 * 4 * 4,))).add(jnn.Linear(48, 5)))
    t = (tnn.Sequential()
         .add(tnn.SpatialConvolution(2, 3, 3, 3, device="cpu"))
         .add(tnn.Reshape((3 * 4 * 4,)))
         .add(tnn.Linear(48, 5, device="cpu")))
    _check_layer(j, t, _x(2, 6, 6, 2))
    feat = t.children_in_order()[0](torch.from_numpy(_x(2, 6, 6, 2)))
    nhwc = tnn.Reshape((48,))(feat)
    nchw_view = feat.permute(0, 3, 1, 2).reshape(2, 48)
    assert torch.equal(nhwc, feat.reshape(2, 48))
    assert torch.equal(nhwc.sort(1).values, nchw_view.sort(1).values)
    assert not torch.equal(nhwc, nchw_view)


def test_reshape_without_batch_mode():
    x = _x(2, 3, 4)
    got = tnn.Reshape((4, 6), batch_mode=False)(torch.from_numpy(x))
    want = jnn.Reshape((4, 6), batch_mode=False).forward(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_concat_on_the_channel_axis():
    j = (jnn.Concat(axis=3, name="blk")
         .add(jnn.SpatialConvolution(3, 4, 1, 1))
         .add(jnn.Sequential().add(jnn.SpatialConvolution(3, 2, 3, 3,
                                                          pad_w=1, pad_h=1))
              .add(jnn.ReLU())))
    t = (tnn.Concat(axis=3, name="blk")
         .add(tnn.SpatialConvolution(3, 4, 1, 1, device="cpu"))
         .add(tnn.Sequential().add(tnn.SpatialConvolution(
             3, 2, 3, 3, pad_w=1, pad_h=1, device="cpu")).add(tnn.ReLU())))
    assert [k for k, _ in t.named_children()] == ["0_SpatialConvolution",
                                                 "1_Sequential"]
    out = _check_layer(j, t, _x(2, 5, 5, 3))
    assert out.shape == (2, 5, 5, 6)


def test_concat_on_the_class_axis():
    j = (jnn.Concat(axis=1).add(jnn.Linear(6, 3)).add(jnn.Linear(6, 2)))
    t = (tnn.Concat(axis=1).add(tnn.Linear(6, 3, device="cpu"))
         .add(tnn.Linear(6, 2, device="cpu")))
    assert _check_layer(j, t, _x(4, 6)).shape == (4, 5)


@pytest.mark.parametrize("kind,k,s,pad,hw,out_hw", [
    ("max", 3, 2, 0, 112, 56),   # the stem pools
    ("max", 3, 2, 0, 56, 28),
    ("max", 3, 2, 0, 28, 14),
    ("max", 3, 2, 0, 14, 7),
    ("max", 3, 1, 1, 14, 14),    # v2's max pool with projection
    ("avg", 3, 1, 1, 28, 28),    # v2's avg-pool branch
    ("avg", 5, 3, 0, 14, 4),     # the auxiliary heads
    ("avg", 7, 1, 0, 7, 1),      # v2's global pool
])
def test_pools_in_ceil_mode_at_inception_shapes(kind, k, s, pad, hw, out_hw):
    cls = "SpatialMaxPooling" if kind == "max" else "SpatialAveragePooling"
    kw = dict(pad_w=pad, pad_h=pad)
    j = getattr(jnn, cls)(k, k, s, s, **kw).ceil()
    t = getattr(tnn, cls)(k, k, s, s, **kw).ceil()
    assert t.ceil_mode and isinstance(t, getattr(tnn, cls))
    out = _check_layer(j, t, _x(1, hw, hw, 3))
    assert out.shape == (1, out_hw, out_hw, 3)


@pytest.mark.parametrize("size,alpha,beta,k", [
    (5, 0.0001, 0.75, 1.0),      # Inception-v1's
    (5, 1.0, 0.75, 1.0),         # a strong normalization
    (4, 0.5, 0.5, 2.0),          # an even window: padding (2, 1)
])
def test_spatial_cross_map_lrn(size, alpha, beta, k):
    _check_layer(jnn.SpatialCrossMapLRN(size, alpha, beta, k),
                 tnn.SpatialCrossMapLRN(size, alpha, beta, k),
                 _x(2, 3, 4, 9, scale=2.0))


def test_spatial_cross_map_lrn_keeps_bf16():
    x = _x(2, 3, 3, 8, scale=3.0)
    got = tnn.SpatialCrossMapLRN(5, 1.0, 0.75)(
        torch.from_numpy(x).to(torch.bfloat16))
    want = jnn.SpatialCrossMapLRN(5, 1.0, 0.75).forward(
        jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    # two bf16 ulps of |y| (each side rounds the window sum and the power)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2 * 2 ** -7, atol=1e-6)


@pytest.mark.parametrize("size_average", [True, False])
def test_mse_criterion(size_average):
    out, target = _x(4, 7, seed=1), _x(4, 7, seed=2)

    def f(o):
        return jnn.MSECriterion(size_average)(o, jnp.asarray(target))
    want, g_want = jax.value_and_grad(f)(jnp.asarray(out))
    ot = torch.from_numpy(out).requires_grad_()
    got = tnn.MSECriterion(size_average)(ot, torch.from_numpy(target))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(ot.grad.numpy(), np.asarray(g_want),
                               atol=1e-7)


class TestDropout:
    N = (200, 500)

    def _run(self, layer, gen):
        layer.train()
        with tnn.lend_generator(gen):
            return layer(torch.ones(self.N))

    @pytest.mark.parametrize("p", [0.3, 0.5, 0.7])
    def test_keep_fraction_and_inverted_scaling(self, p):
        y = self._run(tnn.Dropout(p),
                      torch.Generator().manual_seed(3))
        kept = (y != 0).float().mean().item()
        # 1e5 draws: the keep fraction's std is ~1.6e-3
        assert abs(kept - (1 - p)) < 0.01
        assert torch.allclose(y[y != 0], torch.tensor(1 / (1 - p)))
        assert abs(y.mean().item() - 1.0) < 0.03
        # the reference's keep fraction on the same number of draws
        jy = jnn.Dropout(p).forward(jnp.ones(self.N), training=True,
                                    rng=jax.random.PRNGKey(3))
        assert abs(float(jnp.mean(jy != 0)) - (1 - p)) < 0.01

    def test_without_scaling(self):
        y = self._run(tnn.Dropout(0.4, False, False),
                      torch.Generator().manual_seed(0))
        assert set(y.unique().tolist()) == {0.0, 1.0}

    def test_eval_and_p_zero_are_the_identity(self):
        x = torch.from_numpy(_x(3, 5))
        layer = tnn.Dropout(0.5)
        layer.eval()
        assert layer(x) is x
        zero = tnn.Dropout(0.0)
        zero.train()
        assert zero(x) is x

    def test_same_generator_state_same_mask(self):
        a = self._run(tnn.Dropout(0.5), torch.Generator().manual_seed(5))
        b = self._run(tnn.Dropout(0.5), torch.Generator().manual_seed(5))
        c = self._run(tnn.Dropout(0.5), torch.Generator().manual_seed(6))
        assert torch.equal(a, b) and not torch.equal(a, c)

    def test_training_without_a_generator_raises(self):
        layer = tnn.Dropout(0.5)
        layer.train()
        with pytest.raises(ValueError, match="generator"):
            layer(torch.ones(2, 3))

    def test_meta_draws_nothing(self):
        layer = tnn.Dropout(0.5)
        layer.train()
        assert layer(torch.ones(2, 3, device="meta")).shape == (2, 3)


# ------------------------------------------------------------ trajectories

STEPS = 3


def _jax_trajectory(jmod, params, state, x, y, loss_fn, lr):
    method = joptim.SGD(learning_rate=lr, momentum=0.9)
    opt_state = method.init_state(params)

    @jax.jit
    def step(params, opt_state, state):
        def f(p):
            out, new = functional_apply(jmod, p, jnp.asarray(x),
                                        state=state, training=True)
            return loss_fn(out, y), new
        (loss, new), g = jax.value_and_grad(f, has_aux=True)(params)
        params, opt_state = method.update(g, opt_state, params, lr)
        return params, opt_state, merge_state(state, new), loss

    out = []
    for _ in range(STEPS):
        params, opt_state, state, loss = step(params, opt_state, state)
        out.append((float(loss), _np(params),
                    {k: _np(v) for k, v in state.items()}))
    return out


def _port_trajectory(tmod, x, y, criterion, lr, steps=STEPS):
    opt = toptim.DistriOptimizer(tmod, LocalDataSet([MiniBatch(x, y)]),
                                 criterion, devices=["cpu"])
    opt.set_optim_method(toptim.SGD(learning_rate=lr, momentum=0.9))
    opt.set_end_when(toptim.max_iteration(steps))
    out = []
    # copies: on the CPU the exported arrays share the live parameters'
    # memory, which the next step updates in place
    opt.set_iteration_hook(lambda s: out.append(
        (s["loss"], _np_copy(module_params_tree(tmod)),
         _np_copy(module_state(tmod)))))
    opt.optimize()
    return out


def _check_trajectory(jmod, tmod, x, y, j_loss, t_loss, lr=0.05,
                      loss_rtol=1e-4, rel=1e-4):
    params, state = _carry(jmod, tmod)
    want = _jax_trajectory(jmod, params, state, x, y, j_loss, lr)
    got = _port_trajectory(tmod, x, y, t_loss, lr)
    assert len(got) == len(want) == STEPS
    for i, ((lt, pt, st), (lj, pj, sj)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(lt, lj, rtol=loss_rtol,
                                   err_msg=f"loss, step {i + 1}")
        _assert_trees_close(pt, pj, rel=rel, path=f"step {i + 1}")
        assert set(st) == set(sj)
        for path in sj:
            _assert_trees_close(st[path], sj[path], rel=rel,
                                path=f"step {i + 1} {path}")
    return [lt for lt, _, _ in got]


def _weighted_sum(w):
    """The blocks' loss: sum(out * w) over a sample, averaged over the
    batch, in both packages."""
    def j(out, _):
        return jnp.sum(out * w) / out.shape[0]

    def t(out, _):
        return (out * torch.from_numpy(w)).sum() / out.shape[0]
    return j, t


def _block_case(jmod, tmod, hw=16, c=16):
    x = _x(2, hw, hw, c, seed=4)
    params, _ = _carry(jmod, tmod)
    out, _ = functional_apply(jmod, params, jnp.asarray(x), training=True)
    w = _x(*np.shape(out), seed=5)
    j_loss, t_loss = _weighted_sum(w)
    return _check_trajectory(jmod, tmod, x, np.zeros(2, np.int32), j_loss,
                             t_loss, lr=0.01, loss_rtol=1e-5)


def test_inception_module_trajectory():
    args = (16, 8, 4, 8, 2, 4, 4)
    tmod = tmodels.inception_module(*args, "inception_3a/", device="cpu")
    jmod = jinc.inception_module(*args, "inception_3a/")
    assert "0_inception_3a/1x1" in dict(
        tmod.named_modules())["0_Sequential"]._modules
    _block_case(jmod, tmod)


@pytest.mark.parametrize("c1,pool", [(8, ("avg", 4)), (8, ("max", 4)),
                                     (0, ("max", 0))],
                         ids=["avg", "max with projection",
                              "stride-2 reduction"])
def test_inception_layer_v2_trajectory(c1, pool):
    args = (16, c1, (4, 8), (4, 6), pool, "inception_4a/")
    tmod = tmodels.inception_layer_v2(*args, device="cpu")
    jmod = jinc.inception_layer_v2(*args)
    bns = [n for n, m in tmod.named_modules()
           if isinstance(m, tnn.BatchNormalization)]
    assert len(bns) == (1 if c1 else 0) + 2 + 3 + (1 if pool[1] else 0)
    tbk.BnReluFunction.g_copies = 0
    _block_case(jmod, tmod)
    # each branch's last BN+ReLU gets a channel slice of the joined
    # gradient, which the fused backward reads in place: no copy
    assert tbk.BnReluFunction.g_copies == 0


def _nll():
    return (lambda out, y: jnn.ClassNLLCriterion()(out, y),
            tnn.ClassNLLCriterion())


def test_lenet5_trajectory():
    rs = np.random.RandomState(6)
    x = rs.rand(8, 28, 28).astype(np.float32)
    y = (rs.randint(0, 10, 8) + 1).astype(np.int32)
    losses = _check_trajectory(jlenet.LeNet5(10),
                               tmodels.LeNet5(10, device="cpu"), x, y,
                               *_nll())
    assert losses[-1] < losses[0]


def _cifar_vgg_pair():
    """`VggForCifar10(10)` in both packages, every `Dropout.p` set to 0,
    and a seeded batch of 4 at 32x32."""
    jmod, tmod = jvgg.VggForCifar10(10), tmodels.VggForCifar10(
        10, device="cpu")
    for mods in (_jax_modules(jmod), list(tmod.modules())):
        drops = [m for m in mods if type(m).__name__ == "Dropout"]
        assert len(drops) == 10
        for m in drops:
            m.p = 0.0
    rs = np.random.RandomState(7)
    x = rs.rand(4, 32, 32, 3).astype(np.float32)
    y = (rs.randint(0, 10, 4) + 1).astype(np.int32)
    return jmod, tmod, x, y


def test_vgg_for_cifar10_trajectory_without_dropout_f64():
    """The 3-step trajectory in f64 in both packages (JAX under
    `jax.enable_x64`; the port's model in f64 with fusion off, since the
    fused kernels take f32 and bf16 only): losses within a relative 1e-9,
    parameters and BN statistics within 1e-6 of their tensor's largest
    element (the export rounds to f32). In f32 the comparison is not well
    conditioned at this batch: the 1-D BN normalizes 4 rows and the last
    stage's 16, and the BN shifts' gradients in either package differ
    from an f64 run by up to 3.4% of their largest element after one
    step; `test_vgg_for_cifar10_f32_step_matches_the_reference_forward`
    holds the f32 fused step."""
    jmod, tmod, x, y = _cifar_vgg_pair()
    params, state = _carry(jmod, tmod, jit=True)
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: np.asarray(a, np.float64), t)
        want = _jax_trajectory(jmod, f64(params),
                               {k: f64(v) for k, v in state.items()},
                               x.astype(np.float64), y,
                               lambda out, yy: jnn.ClassNLLCriterion()(
                                   out, yy), 0.01)
    tmod.double()
    with tnn.fusion_scope(False):
        got = _port_trajectory(tmod, x.astype(np.float64), y,
                               tnn.ClassNLLCriterion(), 0.01)
    for i, ((lt, pt, st), (lj, pj, sj)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(lt, lj, rtol=1e-9,
                                   err_msg=f"loss, step {i + 1}")
        _assert_trees_close(pt, pj, rel=1e-6, path=f"step {i + 1}")
        for path in sj:
            _assert_trees_close(st[path], sj[path], rel=1e-6,
                                path=f"step {i + 1} {path}")
    assert got[-1][0] < got[0][0]


def test_vgg_for_cifar10_f32_step_matches_the_reference_forward(
        monkeypatch):
    """The f32 step through the fused BN+ReLU sites (14 of them, no
    gradient copies): its loss within a relative 1e-5 of the reference's
    and the BN running statistics it leaves within 1e-4 of their tensor's
    largest element (forward quantities, well conditioned in f32)."""
    jmod, tmod, x, y = _cifar_vgg_pair()
    params, state = _carry(jmod, tmod, jit=True)

    @jax.jit
    def forward(params):
        out, new = functional_apply(jmod, params, jnp.asarray(x),
                                    state=state, training=True)
        return jnn.ClassNLLCriterion()(out, y), merge_state(state, new)

    lj, sj = forward(params)
    sj = {k: _np(v) for k, v in sj.items()}
    calls = {"fwd": 0, "bwd": 0}

    def counted(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tbk, "bn_relu_forward",
                        counted("fwd", tbk.bn_relu_forward))
    monkeypatch.setattr(tbk, "bn_relu_backward",
                        counted("bwd", tbk.bn_relu_backward))
    tbk.BnReluFunction.g_copies = 0
    (lt, _, st), = _port_trajectory(tmod, x, y, tnn.ClassNLLCriterion(),
                                    0.01, steps=1)
    np.testing.assert_allclose(lt, float(lj), rtol=1e-5)
    for path in sj:
        _assert_trees_close(st[path], sj[path], rel=1e-4, path=str(path))
    assert calls == {"fwd": 14, "bwd": 14}
    assert tbk.BnReluFunction.g_copies == 0


def _jax_modules(m):
    out = [m]
    for child in getattr(m, "children", []):
        out += _jax_modules(child)
    return out


def test_autoencoder_trajectory():
    x = np.random.RandomState(8).rand(8, 28, 28).astype(np.float32)
    target = x.reshape(8, 784)
    losses = _check_trajectory(
        jae.Autoencoder(32), tmodels.Autoencoder(32, device="cpu"), x,
        target, lambda out, y: jnn.MSECriterion()(out, jnp.asarray(y)),
        tnn.MSECriterion(), lr=0.5)
    assert losses[-1] < losses[0]


# ------------------------------------------------------------ full depth

def _flat(tree, path=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{path}/{k}"))
        else:
            out[f"{path}/{k}"] = tuple(v.shape)
    return out


FULL_DEPTH = {
    "Inception_v1": ((1000,), {}),
    "Inception_v1_NoAuxClassifier": ((1000,), {"s2d_stem": True}),
    "Inception_v2": ((1000,), {}),
    "Inception_v2_NoAuxClassifier": ((1000,), {}),
    "Vgg_16": ((1000,), {}),
    "Vgg_19": ((1000,), {}),
}


@pytest.mark.parametrize("name", list(FULL_DEPTH))
def test_full_depth_parameter_tree_equals_the_reference(name):
    args, kw = FULL_DEPTH[name]
    ref = getattr(jinc if "Inception" in name else jvgg, name)(*args, **kw)
    with jax.ensure_compile_time_eval():
        want = _flat(jax.eval_shape(ref.init, jax.random.PRNGKey(0)))
    port = getattr(tmodels, name)(*args, **kw, device="meta")
    got = _flat(_module_targets(port))
    assert got == want
    n = sum(int(np.prod(s)) for s in want.values())
    assert sum(p.numel() for p in port.parameters()) == n
    assert n > 5_000_000


@pytest.mark.parametrize("name", ["Inception_v2",
                                  "Inception_v2_NoAuxClassifier",
                                  "VggForCifar10"])
def test_full_depth_bn_state_paths_equal_the_reference(name):
    """The BN running statistics carry both ways at the reference's state
    paths (module-path tuples)."""
    module = jvgg if name == "VggForCifar10" else jinc
    n_class = 10 if name == "VggForCifar10" else 1000
    want = getattr(module, name)(n_class).state_init()
    port = getattr(tmodels, name)(n_class, device="meta")
    assert set(_bn_modules(port)) == set(want)
    assert all(set(v) == {"mean", "var"} for v in want.values())


def test_inception_v2_has_69_fused_sites_and_paths_of_the_reference():
    port = tmodels.Inception_v2_NoAuxClassifier(1000, device="meta")
    names = [n for n, m in port.named_modules()
             if isinstance(m, tnn.BatchNormalization)]
    assert len(names) == 69
    assert names[0] == "0_Sequential.1_conv1/7x7_s2/bn"
    assert "14_inception_5b/output.3_Sequential.1_Sequential.1_" \
        "inception_5b/pool_proj/bn" in names


# ------------------------------------------------------------ the bench

@pytest.mark.parametrize("name,batch", [("lenet", 8), ("inception_v1", 1),
                                        ("inception_v2", 1)])
def test_bench_zoo_on_the_cpu(name, batch):
    res = bench.bench_zoo(name, batch_size=batch, warmup=2, iters=2, sync=2,
                          device="cpu")
    assert res["model"] == name and len(res["losses"]) == 4
    assert all(np.isfinite(res["losses"]))
    assert res["flops_per_step"] > 0 and res["mfu"] is None


def test_profile_zoo_needs_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        bench.profile_zoo("inception_v1", device="cpu")


def test_zoo_step_counts_the_same_on_the_cpu_and_the_meta_device():
    """`count_flops` of a step of an Inception-v2 block model: on the CPU
    (plain versions, kernels 6-7 by their formulas) and on the meta device
    (`bench.step_flops`) one number, with the 7 BN+ReLU sites counted by
    the kernels' formulas."""
    model = (tnn.Sequential()
             .add(tmodels.inception_layer_v2(8, 4, (4, 4), (4, 6),
                                             ("avg", 2), device="cpu"))
             .add(tnn.SpatialAveragePooling(8, 8))
             .add(tnn.Reshape((16,)))
             .add(tnn.Linear(16, 3, device="cpu"))
             .add(tnn.LogSoftMax()))
    rs = np.random.RandomState(2)
    x = rs.rand(2, 8, 8, 8).astype(np.float32)
    y = (rs.randint(0, 3, 2) + 1).astype(np.int32)
    opt = toptim.DistriOptimizer(model, LocalDataSet([MiniBatch(x, y)]),
                                 tnn.ClassNLLCriterion(), devices=["cpu"])
    state = opt.optim_method.init_state_with_masters(
        dict(model.named_parameters()))
    copies = tbk.BnReluFunction.g_copies
    on_cpu = costs.count_flops(opt._build_step(), state,
                               torch.from_numpy(x), torch.from_numpy(y),
                               0.01)
    # the four branches' last BN+ReLU each read their Concat slice in
    # place; the meta step copies nothing and counts nothing
    assert tbk.BnReluFunction.g_copies == copies
    assert on_cpu == bench.step_flops(opt)
    assert tbk.BnReluFunction.g_copies == copies
    with tnn.fusion_scope(False):
        plain = bench.step_flops(opt)
    n_c = 2 * 8 * 8 * (4 + 4 + 4 + 4 + 6 + 6 + 2)  # the sites' N * C
    assert on_cpu - plain == 10 * n_c
