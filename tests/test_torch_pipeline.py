"""Pipeline parallelism in the port against the JAX package
(`bigdl_tpu_torch/parallel/pipeline.py` against
`bigdl_tpu/parallel/pipeline.py`).

The JAX side runs its `shard_map` programs on the conftest's virtual CPU
devices; the port runs the same schedules on a mesh that names the CPU
several times. Parameters go from the JAX trees into the port through
`interop` (`load_gpipe_params`, `load_pipeline_params`) and gradients come
back through `pipeline_params_tree`. Tolerances: outputs and gradients
within rtol 1e-4, atol 1e-5 (f32 sums in another order); ResNet-50 at
2e-4, as the reference's own test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import bigdl_tpu.nn as jnn
from bigdl_tpu.models import ResNet as JResNet
from bigdl_tpu.nn.module import functional_apply
from bigdl_tpu.parallel import pipeline as jpipe

import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.interop import (load_gpipe_params, load_module_params,
                                     load_pipeline_params,
                                     module_params_tree,
                                     pipeline_params_tree)
from bigdl_tpu_torch.models import ResNet
from bigdl_tpu_torch.parallel import (GPipe, Mesh, PipelineStages,
                                      split_sequential)
from bigdl_tpu_torch.parallel import pipeline as tpipe
from bigdl_tpu_torch.tools.pipeline_resnet import microbatch_oracle

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops (microbatches, per-expert products). Once JAX has
    started its own threads in the process, torch's intra-op pool of one
    thread a core mostly waits on the others, the more so beside other
    test workers, so this file runs torch on one thread and puts the
    setting back after."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _jmesh(n):
    return JaxMesh(np.array(jax.devices()[:n]).reshape(n), ("pipe",))


def _tmesh(n):
    return Mesh(["cpu"] * n, ("pipe",))


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _tree_close(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _tree_close(got[k], want[k])
        else:
            _close(got[k], want[k])


def _mse_j(pred, y):
    return jnp.mean((pred - y) ** 2)


def _mse_t(pred, y):
    return torch.mean((pred - y) ** 2)


# ------------------------------------------------------------- schedules


@pytest.mark.parametrize("n_stages", [2, 3, 4, 5])
def test_1f1b_tables_equal_the_reference(n_stages):
    for m in range(1, 13):
        assert tpipe._schedule_1f1b(n_stages, m) == \
            jpipe._schedule_1f1b(n_stages, m), (n_stages, m)


def test_bubble_fractions_equal_the_reference():
    for s, m in [(4, 4), (4, 16), (2, 8), (3, 5)]:
        tg = GPipe(tnn.Linear(4, 4, device="cpu"), s, m)
        jg = jpipe.GPipe(jnn.Linear(4, 4), s, m)
        assert tg.bubble_fraction == jg.bubble_fraction
    stages = [tnn.Linear(4, 4, device="cpu") for _ in range(4)]
    jp = jpipe.PipelineStages([jnn.Linear(4, 4) for _ in range(4)], 8,
                              jnp.zeros((2, 4)))
    for m in (1, 4, 8, 12):
        tp = PipelineStages(stages, m, torch.zeros(2, 4))
        jp.n_micro = m  # the reference reads the table at each call
        assert tp.bubble_fraction == jp.bubble_fraction
    assert tp.boundary_shapes == [((2, 4), torch.float32)] * 5
    assert tp.act_pad == jp.act_pad == 8


# ------------------------------------------------------------------ GPipe


def test_gpipe_matches_the_jax_pipeline():
    """Params carried from JAX's stacked tree, one slice a stage copy; 8
    microbatches over 4 stages."""
    n_stages, n_micro, batch = 4, 8, 16
    jblock = jnn.Sequential().add(jnn.Linear(16, 16)).add(jnn.Tanh())
    jg = jpipe.GPipe(jblock, n_stages=n_stages, n_micro=n_micro)
    params = jg.init(jax.random.PRNGKey(0))
    tblock = (tnn.Sequential().add(tnn.Linear(16, 16, device="cpu"))
              .add(tnn.Tanh()))
    tg = GPipe(tblock, n_stages=n_stages, n_micro=n_micro)
    load_gpipe_params(tg, jax.tree_util.tree_map(np.asarray, params))
    x = np.random.RandomState(0).randn(batch, 16).astype(np.float32)
    want = jg.pipeline_apply(_jmesh(n_stages),
                             jg.place_params(_jmesh(n_stages), params),
                             jnp.asarray(x))
    got = tg.pipeline_apply(_tmesh(n_stages), torch.from_numpy(x))
    _close(got, want)
    _close(tg(torch.from_numpy(x)), got)


def test_gpipe_params_tree_round_trip_and_gradients():
    """`gpipe_params_tree` stacks the copies back into JAX's layout, and
    autograd through `pipeline_apply` gives the sequential forward's
    gradients."""
    from bigdl_tpu_torch.interop import gpipe_params_tree
    jblock = jnn.Sequential().add(jnn.Linear(8, 8)).add(jnn.Tanh())
    params = jpipe.GPipe(jblock, n_stages=4, n_micro=8).init(
        jax.random.PRNGKey(3))
    tg = GPipe(tnn.Sequential().add(tnn.Linear(8, 8, device="cpu"))
               .add(tnn.Tanh()), n_stages=4, n_micro=8)
    load_gpipe_params(tg, jax.tree_util.tree_map(np.asarray, params))
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), b), params, gpipe_params_tree(tg))
    x = torch.from_numpy(np.random.RandomState(3).randn(16, 8)
                         .astype(np.float32))
    torch.sum(tg(x) ** 2).backward()
    want = gpipe_params_tree(tg, grad=True)
    tg.zero_grad()
    torch.sum(tg.pipeline_apply(_tmesh(4), x) ** 2).backward()
    jax.tree_util.tree_map(_close, gpipe_params_tree(tg, grad=True), want)


def test_gpipe_refusals():
    tg = GPipe(tnn.Linear(4, 4, device="cpu"), n_stages=4, n_micro=3)
    with pytest.raises(ValueError, match="pipe"):
        tg.pipeline_apply(_tmesh(2), torch.ones(6, 4))
    with pytest.raises(ValueError, match="divisible"):
        tg.pipeline_apply(_tmesh(4), torch.ones(8, 4))


# ------------------------------------------------------ PipelineStages


def _hetero(pkg, device=None):
    """The hetero Linear stages of the reference's dry run."""
    kw = {} if device is None else {"device": device}
    return [pkg.Sequential().add(pkg.Linear(8, 16, **kw)).add(pkg.Tanh()),
            pkg.Sequential().add(pkg.Linear(16, 12, **kw)).add(pkg.ReLU()),
            pkg.Sequential().add(pkg.Linear(12, 6, **kw)).add(pkg.Tanh()),
            pkg.Linear(6, 4, **kw)]


def _pair(jstages, tstages, n_micro, example, seed):
    jp = jpipe.PipelineStages(jstages, n_micro=n_micro,
                              example_input=jnp.zeros(example))
    params = jp.init(jax.random.PRNGKey(seed))
    tp = PipelineStages(tstages, n_micro, torch.zeros(example))
    load_pipeline_params(tp, jax.tree_util.tree_map(np.asarray, params))
    return jp, tp, params


def _check_1f1b(jp, tp, params, x, y, n):
    jloss, jgrads = jp.train_step_1f1b(_jmesh(n), params, jnp.asarray(x),
                                       jnp.asarray(y), _mse_j)
    tloss, tgrads = tp.train_step_1f1b(_tmesh(n), torch.from_numpy(x),
                                       torch.from_numpy(y), _mse_t)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    for got, want in zip(pipeline_params_tree(tp, tgrads), jgrads):
        _tree_close(got, jax.device_get(want))


def test_hetero_stages_forward_and_1f1b_match_jax():
    """The dry run's hetero stages: `pipeline_apply` against JAX's, and
    `train_step_1f1b`'s loss and every gradient against JAX's 1F1B."""
    jp, tp, params = _pair(_hetero(jnn), _hetero(tnn, "cpu"), 8, (2, 8), 3)
    rs = np.random.RandomState(3)
    x = rs.randn(16, 8).astype(np.float32)
    y = rs.randn(16, 4).astype(np.float32)
    want = jp.pipeline_apply(_jmesh(4), params, jnp.asarray(x))
    _close(tp.pipeline_apply(_tmesh(4), torch.from_numpy(x)), want)
    _check_1f1b(jp, tp, params, x, y, 4)


def _conv_bn(pkg, device=None):
    """Conv -> BN -> ReLU stages (convs without a bias before BN: its
    gradient is analytically zero)."""
    kw = {} if device is None else {"device": device}
    return [
        pkg.Sequential()
        .add(pkg.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1, with_bias=False,
                                    **kw))
        .add(pkg.SpatialBatchNormalization(4, **kw)).add(pkg.ReLU()),
        pkg.Sequential()
        .add(pkg.SpatialConvolution(4, 6, 3, 3, 2, 2, 1, 1, with_bias=False,
                                    **kw))
        .add(pkg.SpatialBatchNormalization(6, **kw)).add(pkg.ReLU()),
        pkg.Sequential().add(pkg.Pooler()).add(pkg.Linear(6, 5, **kw))]


def _randomize_bn(params, seed):
    """BN gammas ~ U(0.5, 1.5) (a zero-initialized one U(0.05, 0.15), or
    the 16 residual sums of ResNet-50 blow up) and betas ~ N(0, 0.1)."""
    rs = np.random.RandomState(seed)

    def walk(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("weight", "bias") and np.ndim(v) == 1:
                scale = 1.0 if np.any(v) else 0.1
                out[k] = ((rs.rand(*np.shape(v)) + 0.5) * scale
                          if k == "weight" else rs.randn(*np.shape(v)) * 0.1
                          ).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return [walk(p) for p in params]


def test_conv_bn_stages_hold_per_microbatch_bn_to_jax():
    """Each microbatch normalized by its own statistics in both packages:
    the 1F1B loss and every gradient, BN's parameters included."""
    jstages, tstages = _conv_bn(jnn), _conv_bn(tnn, "cpu")
    jp = jpipe.PipelineStages(jstages, n_micro=4,
                              example_input=jnp.zeros((2, 8, 8, 3)))
    params = _randomize_bn(jp.init(jax.random.PRNGKey(5)), 5)
    tp = PipelineStages(tstages, 4, torch.zeros(2, 8, 8, 3))
    load_pipeline_params(tp, params)
    rs = np.random.RandomState(5)
    x = rs.randn(8, 8, 8, 3).astype(np.float32)
    y = rs.randn(8, 5).astype(np.float32)
    _check_1f1b(jp, tp, params, x, y, 3)


def test_pipelined_paths_leave_bn_buffers_and_modes_as_found():
    tp = PipelineStages(_conv_bn(tnn, "cpu"), 4, torch.zeros(2, 8, 8, 3))
    for st in tp.stages:
        for name, b in st.named_buffers():
            b.copy_(torch.rand(b.shape,
                               generator=torch.Generator().manual_seed(7)))
    tp.stages[1].train()
    before = [{n: b.clone() for n, b in st.named_buffers()}
              for st in tp.stages]
    modes = [[m.training for m in st.modules()] for st in tp.stages]
    rs = np.random.RandomState(6)
    x = torch.from_numpy(rs.randn(8, 8, 8, 3).astype(np.float32))
    y = torch.from_numpy(rs.randn(8, 5).astype(np.float32))
    tp.pipeline_apply(_tmesh(3), x, training=True)
    tp.pipeline_apply(_tmesh(3), x)
    tp.train_step_1f1b(_tmesh(3), x, y, _mse_t)
    for st, saved, mode in zip(tp.stages, before, modes):
        for n, b in st.named_buffers():
            assert torch.equal(b, saved[n]), n
        assert [m.training for m in st.modules()] == mode


def test_resnet50_pipeline_apply_matches_jax_sequential_apply():
    """ResNet-50 at 32x32, split into 4 stages: the port's pipelined
    forward against JAX's sequential `apply` of the same weights (eval
    mode, initial statistics), at the reference's 2e-4. Then the port's
    1F1B against its own microbatch oracle (the stages' sequential forward
    and backward a microbatch, loss/M, gradients summed)."""
    model = ResNet(class_num=10, depth=50, device="cpu")
    stages = split_sequential(model, 4)
    assert [len(s.children_in_order()) for s in stages] == [6, 6, 5, 6]
    params = _randomize_bn([module_params_tree(model)], 2)[0]
    load_module_params(model, params)
    jmodel = JResNet(class_num=10, depth=50)
    x = np.random.RandomState(2).rand(8, 32, 32, 3).astype(np.float32)
    want = jax.jit(lambda p, v: functional_apply(jmodel, p, v)[0])(
        params, jnp.asarray(x))
    pipe = PipelineStages(stages, 4, torch.zeros(2, 32, 32, 3))
    got = pipe.pipeline_apply(_tmesh(4), torch.from_numpy(x))
    _close(got, want, rtol=2e-4, atol=2e-4)

    y = torch.from_numpy(np.random.RandomState(3).randint(1, 11, 8))
    crit = tnn.ClassNLLCriterion()
    loss, grads = pipe.train_step_1f1b(_tmesh(4), torch.from_numpy(x), y,
                                       crit)
    oloss, ograds = microbatch_oracle(pipe, torch.from_numpy(x), y, crit)
    assert float(loss) == pytest.approx(float(oloss), rel=1e-6)
    for g, o in zip(grads, ograds):
        for n in o:
            _close(g[n], o[n], rtol=1e-5, atol=1e-6)


def test_ravel_and_unravel_stacked_round_trip():
    tp = PipelineStages(_hetero(tnn, "cpu"), 4, torch.zeros(2, 8))
    stacked = tp.ravel_stacked()
    assert stacked.shape == (4, 16 * 12 + 12)
    back = tp.unravel_stacked(stacked)
    for got, want in zip(back, tp.init()):
        assert list(got) == list(want)
        for n in want:
            assert torch.equal(got[n], want[n].detach())


def test_split_sequential_boundaries_and_errors():
    def identity_model(pkg, n):
        m = pkg.Sequential()
        for _ in range(n):
            m.add(pkg.Identity())
        return m

    for n, s, cuts in [(10, 3, [2, 7]), (10, 3, None), (23, 4, None),
                       (5, 5, None)]:
        got = split_sequential(identity_model(tnn, n), s, cuts)
        want = jpipe.split_sequential(identity_model(jnn, n), s, cuts)
        assert [len(st.children_in_order()) for st in got] == \
            [len(st.children) for st in want]
        assert [st.name for st in got] == [st.name for st in want]
    with pytest.raises(ValueError, match="increasing"):
        split_sequential(identity_model(tnn, 10), 3, boundaries=[7, 2])
    with pytest.raises(ValueError, match="cannot make"):
        split_sequential(identity_model(tnn, 2), 3)


def test_pipeline_stages_refusals():
    tp = PipelineStages(_hetero(tnn, "cpu"), 4, torch.zeros(4, 8))
    with pytest.raises(ValueError, match="need at least 2"):
        PipelineStages(_hetero(tnn, "cpu")[:1], 4, torch.zeros(4, 8))
    with pytest.raises(ValueError, match="pipe"):
        tp.pipeline_apply(_tmesh(2), torch.zeros(16, 8))
    with pytest.raises(ValueError, match="pipe"):
        tp.train_step_1f1b(Mesh(["cpu"] * 4, ("data",)), torch.zeros(16, 8),
                           torch.zeros(16, 4), _mse_t)
    with pytest.raises(ValueError, match="divisible"):
        tp.pipeline_apply(_tmesh(4), torch.zeros(18, 8))
    with pytest.raises(ValueError, match="example shape"):
        tp.train_step_1f1b(_tmesh(4), torch.zeros(8, 8), torch.zeros(8, 4),
                           _mse_t)
    stages = _hetero(tnn, "cpu")
    stages[3] = tnn.Sequential().add(tnn.Linear(6, 4, device="cpu")
                                     ).quantize()
    tq = PipelineStages(stages, 4, torch.zeros(4, 8))
    with pytest.raises(TypeError, match="f32-compatible"):
        tq.pipeline_apply(_tmesh(4), torch.zeros(16, 8))
    with pytest.raises(TypeError, match="f32-compatible"):
        tq.train_step_1f1b(_tmesh(4), torch.zeros(16, 8),
                           torch.zeros(16, 4), _mse_t)


def test_pipeline_resnet_tool_trains_on_the_cpu(capsys):
    """`tools/pipeline_resnet.py`, the reference example's flags: the small
    CNN's 1F1B step against its microbatch oracle, then training."""
    from bigdl_tpu_torch.tools.pipeline_resnet import main
    losses = main(["--device", "cpu", "--steps", "6"])
    assert losses[-1] < losses[0]
    assert "1F1B step loss" in capsys.readouterr().out
