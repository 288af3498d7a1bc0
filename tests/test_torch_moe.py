"""Mixture-of-Experts in the port against the JAX package
(`bigdl_tpu_torch/parallel/moe.py` against `bigdl_tpu/parallel/moe.py`).

The JAX `MoE.init` dict carries into the port through
`interop.load_module_params` (the port's parameters are its keys). The
JAX expert-parallel path runs on the conftest's virtual CPU devices, the
port's on a mesh that names the CPU four times. Routing must agree
exactly (the drop masks); outputs and statistics within rtol 1e-4, atol
1e-5 (f32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from bigdl_tpu.nn.module import ApplyContext
from bigdl_tpu.parallel.moe import MoE as JMoE

from bigdl_tpu_torch.interop import load_module_params, module_params_tree
from bigdl_tpu_torch.parallel import Mesh, MoE

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


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _pair(top_k, n_experts=4, capacity_factor=1.25, skew=2.0, seed=3):
    """The JAX MoE with its params (the router skewed so that experts
    overflow) and the port's twin carrying them."""
    jm = JMoE(8, 16, n_experts, capacity_factor=capacity_factor,
              top_k=top_k)
    params = dict(jm.init(jax.random.PRNGKey(seed)))
    params["router"] = params["router"] + jnp.asarray(
        np.random.RandomState(seed).randn(8, n_experts) * skew, jnp.float32)
    tm = MoE(8, 16, n_experts, capacity_factor, top_k, device="cpu")
    load_module_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, tm, params


def _x(n, seed=4):
    return np.random.RandomState(seed).randn(n, 8).astype(np.float32)


def _jit(fn, *args):
    """`fn(*args)` on the JAX side, compiled as one program (eager JAX
    compiles every op on its own, several times slower)."""
    return jax.jit(fn)(*args)


@pytest.mark.parametrize("top_k", [1, 2])
def test_dense_forward_and_aux_match_jax(top_k):
    jm, tm, params = _pair(top_k, skew=0.5)
    x = _x(32)
    jdense, (jy, jaux), (jex, jgates, jprobs) = _jit(
        lambda p, v: (jm.apply(p, v, ApplyContext()),
                      jm.apply_with_aux(p, v), jm._gates(p, v)),
        params, jnp.asarray(x))
    _close(tm(torch.from_numpy(x)), jdense)
    y, aux = tm.apply_with_aux(torch.from_numpy(x))
    _close(y, jy)
    assert set(aux) == set(jaux)
    for k in jaux:
        _close(aux[k], jaux[k])
    # gates and experts
    ex, gates, probs = tm._gates(torch.from_numpy(x))
    np.testing.assert_array_equal(ex.numpy(), np.asarray(jex))
    _close(gates, jgates)
    _close(probs, jprobs)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("n_groups", [1, 4])
def test_dense_capacity_apply_matches_jax(top_k, n_groups):
    jm, tm, params = _pair(top_k)
    x = _x(64)
    y, mask = tm.dense_capacity_apply(torch.from_numpy(x), n_groups,
                                      return_mask=True)
    jy, jmask = _jit(lambda p, v: jm.dense_capacity_apply(
        p, v, n_groups, return_mask=True), params, jnp.asarray(x))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    if n_groups > 1:
        assert int((~mask).sum()) > 0, "the skewed router should drop"
    _close(y, jy)
    _close(tm.dense_capacity_apply(torch.from_numpy(x), n_groups), jy)


@pytest.mark.parametrize("top_k,n_experts", [(1, 4), (2, 8)])
def test_expert_parallel_matches_jax_with_drops(top_k, n_experts):
    """A skewed router at capacity factor 1.25 over a 4-wide "expert" axis
    (one and two experts a position): the drop masks equal JAX's and the
    port's own dense capacity oracle's, the outputs JAX's."""
    jm, tm, params = _pair(top_k, n_experts=n_experts)
    x = _x(64)
    jmesh = JaxMesh(np.array(jax.devices()[:4]).reshape(4), ("expert",))
    jy, jmask = _jit(lambda p, v: jm.expert_parallel_apply(
        jmesh, p, v, return_mask=True), params, jnp.asarray(x))
    mesh = Mesh(["cpu"] * 4, ("expert",))
    y, mask = tm.expert_parallel_apply(mesh, torch.from_numpy(x),
                                       return_mask=True)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert int((~mask).sum()) > 0
    _close(y, jy)
    dy, dmask = tm.dense_capacity_apply(torch.from_numpy(x), 4,
                                        return_mask=True)
    assert torch.equal(mask, dmask)
    torch.testing.assert_close(y, dy, rtol=RTOL, atol=ATOL)
    _close(tm.expert_parallel_apply(mesh, torch.from_numpy(x)), jy)


def test_saturated_router_ties_rank_the_lower_expert_first():
    """A saturated softmax gives many experts a probability of exactly 0;
    the second choice among them is the lowest index, as `lax.top_k`
    ranks ties, and the capacity paths drop the units JAX drops."""
    jm, tm, params = _pair(2, n_experts=8, skew=0.0)
    params["router"] = params["router"] * 2000.0
    load_module_params(tm, jax.tree_util.tree_map(np.asarray, params))
    x = _x(64, seed=6)
    ex, _, probs = tm._gates(torch.from_numpy(x))
    jex, jmask = _jit(lambda p, v: (jm._gates(p, v)[0],
                                    jm.dense_capacity_apply(
                                        p, v, 4, return_mask=True)[1]),
                      params, jnp.asarray(x))
    assert int((probs == 0).sum()) > 64, "the softmax should saturate"
    np.testing.assert_array_equal(ex.numpy(), np.asarray(jex))
    mask = tm.dense_capacity_apply(torch.from_numpy(x), 4,
                                   return_mask=True)[1]
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


def test_expert_parallel_without_drops_matches_the_dense_forward():
    _, tm, _ = _pair(2, capacity_factor=8.0, skew=0.0)
    x = torch.from_numpy(_x(16, seed=5))
    y, mask = tm.expert_parallel_apply(Mesh(["cpu"] * 4, ("expert",)), x,
                                       return_mask=True)
    assert bool(mask.all())
    torch.testing.assert_close(y, tm(x), rtol=RTOL, atol=ATOL)


def test_group_capacity_and_params_match_jax():
    for e, k, cf, t in [(4, 1, 1.25, 16), (8, 2, 1.25, 512), (4, 1, 1e-9, 4),
                        (8, 1, 1.0, 1024), (6, 2, 2.0, 7)]:
        assert MoE(8, 16, e, cf, k, device="cpu").group_capacity(t) == \
            JMoE(8, 16, e, cf, k).group_capacity(t)
    jm, tm, params = _pair(1)
    back = module_params_tree(tm)
    assert set(back) == {"router", "w1", "b1", "w2", "b2"}
    for k, v in params.items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
    fresh = MoE(8, 16, 4, device="cpu")
    assert fresh.w1.shape == (4, 8, 16) and fresh.w2.shape == (4, 16, 8)
    assert float(fresh.w1.detach().abs().max()) <= 8 ** -0.5
    assert not fresh.b1.detach().any()


def test_refusals():
    with pytest.raises(ValueError, match="top_k"):
        MoE(8, 16, 4, top_k=3, device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        MoE(8, 16, 1, top_k=2, device="cpu")
    moe = MoE(8, 16, 6, device="cpu")
    x = torch.ones(16, 8)
    with pytest.raises(ValueError, match="divide"):
        moe.expert_parallel_apply(Mesh(["cpu"] * 4, ("expert",)), x)
    with pytest.raises(ValueError, match="divide"):
        moe.expert_parallel_apply(Mesh(["cpu"] * 2, ("data",)), x)
    moe = MoE(8, 16, 4, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        moe.expert_parallel_apply(Mesh(["cpu"] * 4, ("expert",)),
                                  torch.ones(18, 8))
    with pytest.raises(ValueError, match="n_groups"):
        moe.dense_capacity_apply(torch.ones(18, 8), n_groups=4)
