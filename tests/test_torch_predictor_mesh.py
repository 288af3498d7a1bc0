"""The rest of `parallel/mesh.py` and `DistriPredictor` in the port against
the JAX package (`bigdl_tpu/parallel/mesh.py:45-87`,
`bigdl_tpu/optim/predictor.py:170-206`).

The port's mesh names torch devices and may repeat one (`["cpu"] * n`);
the JAX side runs on the conftest's virtual CPU devices. Outputs within
rtol 1e-5, atol 1e-6 (the same f32 arithmetic in another order), shards
bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh, PartitionSpec as JP

import bigdl_tpu.nn as jnn
from bigdl_tpu.optim.predictor import DistriPredictor as JDistriPredictor
from bigdl_tpu.parallel import mesh as jmesh_mod

import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.interop import load_module_params
from bigdl_tpu_torch.optim import DistriPredictor, LocalPredictor
from bigdl_tpu_torch.parallel import (Mesh, NamedSharding, PartitionSpec,
                                      ProcessMesh, build_mesh, data_sharding,
                                      get_shard_map, replicate_sharding,
                                      shard_batch)

P = PartitionSpec


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


def _jmesh(shape, names):
    n = int(np.prod(shape))
    return JaxMesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _tmesh(shape, names):
    return Mesh(np.array(["cpu"] * int(np.prod(shape)),
                         dtype=object).reshape(shape), names)


def _models():
    jm = (jnn.Sequential().add(jnn.Linear(6, 8)).add(jnn.Tanh())
          .add(jnn.Linear(8, 3)).add(jnn.LogSoftMax()))
    params = jm.ensure_params()
    tm = (tnn.Sequential().add(tnn.Linear(6, 8, device="cpu"))
          .add(tnn.Tanh()).add(tnn.Linear(8, 3, device="cpu"))
          .add(tnn.LogSoftMax()))
    load_module_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, tm


def test_distri_predictor_matches_jax_and_local_on_a_ragged_batch():
    """27 rows in batches of 8 over two data positions: the last batch of
    3 is padded to 4 and sliced back."""
    jm, tm = _models()
    x = np.random.RandomState(0).randn(27, 6).astype(np.float32)
    want = JDistriPredictor(jm, batch_size=8, mesh=jmesh_mod.build_mesh(
        data=2, devices=jax.devices()[:2])).predict(x)
    mesh = build_mesh(data=2, devices=["cpu", "cpu"])
    pred = DistriPredictor(tm, 8, mesh)
    got = pred.predict(x)
    local = LocalPredictor(tm, 8, device="cpu").predict(x)
    assert len(got) == len(want) == len(local) == 27
    for g, w, l in zip(got, want, local):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g, l, rtol=1e-5, atol=1e-6)
    cls = pred.predict_class(x)
    assert cls == JDistriPredictor(jm, batch_size=8).predict_class(x)
    assert cls == LocalPredictor(tm, 8, device="cpu").predict_class(x)
    assert all(c in (1, 2, 3) for c in cls)


def test_one_forward_per_distinct_device_and_replacement():
    """A mesh that repeats the CPU runs each batch once; two distinct CPU
    devices ("cpu" and "cpu:0") run it once on each, the second on a
    placed copy, placed again after the parameters change."""
    _, tm = _models()
    x = np.random.RandomState(1).randn(20, 6).astype(np.float32)
    calls = []
    pred = DistriPredictor(tm, 8, Mesh(["cpu"] * 4, ("data",)),
                           convert=False)
    pred.model.register_forward_hook(lambda m, i, o: calls.append(
        i[0].shape[0]))
    local = LocalPredictor(tm, 8, convert=False, device="cpu").predict(x)
    calls.clear()
    got = pred.predict(x)
    assert calls == [8, 8, 4]
    np.testing.assert_allclose(np.stack(got), np.stack(local), rtol=1e-6,
                               atol=1e-7)

    two = DistriPredictor(tm, 8, Mesh(["cpu", "cpu:0"], ("data",)),
                          convert=False)
    calls.clear()
    got = two.predict(x)
    # each batch once on each device (the hook came along with the copy)
    assert calls == [4, 4, 4, 4, 2, 2]
    assert len(two._placed) == 2
    np.testing.assert_allclose(np.stack(got), np.stack(local), rtol=1e-6,
                               atol=1e-7)
    copy_before = two._placed[torch.device("cpu", 0)]
    with torch.no_grad():
        tm.children_in_order()[0].weight.mul_(2.0)
    changed = two.predict(x)
    assert two._placed[torch.device("cpu", 0)] is not copy_before
    want = LocalPredictor(tm, 8, convert=False, device="cpu").predict(x)
    np.testing.assert_allclose(np.stack(changed), np.stack(want),
                               rtol=1e-6, atol=1e-7)


def test_distri_predictor_default_mesh_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        DistriPredictor(_models()[1])


def test_shardings_name_the_reference_specs():
    mesh = build_mesh(data=2, devices=["cpu", "cpu"])
    jm = jmesh_mod.build_mesh(data=2, devices=jax.devices()[:2])
    assert tuple(data_sharding(mesh).spec) == tuple(
        jmesh_mod.data_sharding(jm).spec) == ("data",)
    assert tuple(replicate_sharding(mesh).spec) == tuple(
        jmesh_mod.replicate_sharding(jm).spec) == ()
    assert data_sharding(mesh).mesh is mesh
    assert NamedSharding(mesh, P("data")).spec == data_sharding(mesh).spec


def test_shard_batch_matches_the_jax_placement():
    rs = np.random.RandomState(2)
    batch = {"x": rs.randn(8, 3).astype(np.float32),
             "y": rs.randint(0, 5, 8)}
    jm = jmesh_mod.build_mesh(data=4, devices=jax.devices()[:4])
    want = jmesh_mod.shard_batch(jm, batch)
    got = shard_batch(build_mesh(data=4, devices=["cpu"] * 4), batch)
    for k in batch:
        shards = sorted(want[k].addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        assert len(got[k]) == len(shards) == 4
        for g, s in zip(got[k], shards):
            np.testing.assert_array_equal(g.numpy(), np.asarray(s.data))
    # a one-device mesh: the tree on that device, whole
    one = shard_batch(build_mesh(data=1, devices=["cpu"]), batch)
    np.testing.assert_array_equal(one["x"].numpy(), batch["x"])
    # a process mesh: the rank's own batch, whole, on its device
    whole = shard_batch(ProcessMesh(device="cpu"), batch)
    assert whole["x"].shape == (8, 3)
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(build_mesh(data=3, devices=["cpu"] * 3), batch)


@pytest.mark.parametrize("case", ["rows", "grid", "tuple"])
def test_shard_map_matches_jax_on_a_collective_free_function(case):
    rs = np.random.RandomState(3)
    x = rs.randn(8, 6).astype(np.float32)
    w = rs.randn(6, 4).astype(np.float32)
    if case == "rows":
        shape, names = (4,), ("data",)
        specs, out = (JP("data"), JP()), JP("data")

        def jf(a, b):
            return jnp.tanh(a @ b) * 2

        def tf(a, b):
            return torch.tanh(a @ b) * 2
        args = (x, w)
    elif case == "grid":
        shape, names = (2, 2), ("data", "model")
        specs, out = (JP("data", "model"),), JP("data", "model")

        def jf(a):
            return jnp.sin(a) + a.sum(axis=1, keepdims=True)

        def tf(a):
            return torch.sin(a) + a.sum(dim=1, keepdim=True)
        args = (x,)
    else:
        shape, names = (2, 2), ("data", "model")
        specs, out = (JP("data"), JP()), (JP("data"), JP())

        def jf(a, b):
            return a @ b, b * 3

        def tf(a, b):
            return a @ b, b * 3
        args = (x, w)
    smap = jmesh_mod.get_shard_map()
    want = smap(jf, mesh=_jmesh(shape, names), in_specs=specs,
                out_specs=out)(*[jnp.asarray(a) for a in args])
    t_specs = tuple(P(*s) for s in specs)
    t_out = tuple(P(*s) for s in out) if case == "tuple" else P(*out)
    got = get_shard_map()(tf, _tmesh(shape, names), t_specs, t_out)(
        *[torch.from_numpy(a) for a in args])
    if case != "tuple":
        got, want = (got,), (want,)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-5,
                                   atol=1e-6)
