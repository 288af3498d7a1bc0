"""Zoo models through the model-file format, across packages: `LeNet5`,
`VggForCifar10` and a BN model with trained running statistics load in
the other package and give its forward (within ATOL, the zoo's
single-layer parity tolerance), and the `BigDLModule` trees the two
packages write for the same model compare equal field by field,
Inception-v2's included, where the port's pools also record
`ceil_mode=True` (the reference's `.ceil()` leaves it out of its record,
so its own file reloads those pools in floor mode: `ROADMAP.md`,
reference-side state).

The JAX twins take the port model's parameters and BN state
(`module_params_tree`, `module_state`): no JAX init but the ones the
reference's `ModuleSerializer.load` itself runs.
"""

import hashlib
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.models as jm
import bigdl_tpu.nn as jnn
from bigdl_tpu.proto import bigdl_model_pb2 as pb2
from bigdl_tpu.serialization import ModuleSerializer as JS
import bigdl_tpu_torch.models as tm
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.interop import module_params_tree, module_state
from bigdl_tpu_torch.serialization import ModuleSerializer

ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(t):
    return {k: _np_tree(v) for k, v in t.items()} if isinstance(t, dict) \
        else np.array(t)


def _randomize_bn(model, seed=7):
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, tnn.BatchNormalization):
                mod.mean.copy_(torch.from_numpy(
                    0.1 * rs.randn(*mod.mean.shape).astype(np.float32)))
                mod.var.copy_(torch.from_numpy(
                    rs.rand(*mod.var.shape).astype(np.float32) + 0.5))


def _bn_model():
    """Linear -> BN -> ReLU -> Linear -> LogSoftMax, its running stats
    moved by three training forwards."""
    g = torch.Generator().manual_seed(1)
    m = (tnn.Sequential(name="bn_model")
         .add(tnn.Linear(6, 5, device="cpu", generator=g))
         .add(tnn.BatchNormalization(5, device="cpu"))
         .add(tnn.ReLU())
         .add(tnn.Linear(5, 3, device="cpu", generator=g))
         .add(tnn.LogSoftMax()))
    rs = np.random.RandomState(2)
    m.train()
    with torch.no_grad():
        for _ in range(3):
            m(torch.from_numpy(rs.randn(8, 6).astype(np.float32)))
    assert not torch.equal(m.get_submodule("1_BatchNormalization").mean,
                           torch.zeros(5))
    return m.eval()


def _jax_bn_model():
    return (jnn.Sequential(name="bn_model").add(jnn.Linear(6, 5))
            .add(jnn.BatchNormalization(5)).add(jnn.ReLU())
            .add(jnn.Linear(5, 3)).add(jnn.LogSoftMax()))


#: name -> (port model, JAX model (no params), input)
MODELS = {
    "lenet5": (lambda: tm.LeNet5(10, device="cpu"),
               lambda: jm.LeNet5(10),
               np.random.RandomState(0).rand(2, 28, 28).astype(np.float32)),
    "vgg_cifar": (lambda: tm.VggForCifar10(10, device="cpu"),
                  lambda: jm.VggForCifar10(10),
                  np.random.RandomState(0).rand(2, 32, 32, 3)
                  .astype(np.float32)),
    "bn_model": (_bn_model, _jax_bn_model,
                 np.random.RandomState(3).randn(4, 6).astype(np.float32)),
}

_BUILT = {}


def _port(name):
    if name not in _BUILT:
        m = MODELS[name][0]()
        if name != "bn_model":
            _randomize_bn(m)
        _BUILT[name] = m.eval()
    return _BUILT[name]


def _jax_eval(m):
    """Every module in eval mode (the reference's `evaluate()` sets the
    one it is called on), as the port's `.eval()` does."""
    m.evaluate()
    for child in getattr(m, "children", None) or []:
        _jax_eval(child)
    return m


def _twin(port_model, jax_model):
    jax_model.set_params(jax.tree_util.tree_map(
        jnp.asarray, _np_tree(module_params_tree(port_model))))
    jax_model._state = {k: {s: jnp.asarray(v) for s, v in d.items()}
                        for k, d in module_state(port_model).items()}
    return _jax_eval(jax_model)


def _port_forward(m, x):
    with torch.no_grad():
        return m.eval()(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_a_jax_file_loads_in_the_port(name, tmp_path):
    m = _port(name)
    j = _twin(m, MODELS[name][1]())
    x = MODELS[name][2]
    path = str(tmp_path / "j.bigdl")
    JS.save(j, path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        loaded = ModuleSerializer.load(path, device="cpu")
    want = np.asarray(j.forward(jnp.asarray(x), training=False))
    np.testing.assert_allclose(_port_forward(loaded, x), want, atol=ATOL,
                               rtol=0)
    # the statistics came across, not the fresh ones
    for (_, a), (_, b) in zip(sorted(module_state(loaded).items()),
                              sorted(module_state(m).items())):
        np.testing.assert_array_equal(a["mean"], b["mean"])
        np.testing.assert_array_equal(a["var"], b["var"])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_a_port_file_loads_in_the_jax_package(name, tmp_path):
    m = _port(name)
    x = MODELS[name][2]
    path = str(tmp_path / "t.bigdl")
    ModuleSerializer.save(m, path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no dropped leaf
        loaded = JS.load(path)
    got = np.asarray(loaded.forward(jnp.asarray(x), training=False))
    np.testing.assert_allclose(got, _port_forward(m, x), atol=ATOL, rtol=0)


def _diff_trees(a, b, where="root", out=None):
    """Field-by-field differences of two pb2 `BigDLModule` trees, as
    (where, field, a, b) tuples."""
    out = [] if out is None else out
    for field in ("module_type", "name", "evaluating"):
        if getattr(a, field) != getattr(b, field):
            out.append((where, field, getattr(a, field), getattr(b, field)))
    if list(a.ctor_args) != list(b.ctor_args):
        out.append((where, "ctor_args", list(a.ctor_args),
                    list(b.ctor_args)))
    ka, kb = dict(a.ctor_kwargs), dict(b.ctor_kwargs)
    for k in sorted(set(ka) | set(kb)):
        if ka.get(k) != kb.get(k):
            out.append((where, f"ctor_kwargs[{k}]", ka.get(k), kb.get(k)))
    if a.HasField("graph") or b.HasField("graph"):
        out.append((where, "graph", a.graph, b.graph))
    if len(a.children) != len(b.children):
        out.append((where, "children", len(a.children), len(b.children)))
    for i, (x, y) in enumerate(zip(a.children, b.children)):
        _diff_trees(x, y, f"{where}/{i}_{x.name}", out)
    return out


def _files(port_model, jax_model, tmp_path):
    pj, pt = str(tmp_path / "j.bigdl"), str(tmp_path / "t.bigdl")
    JS.save(_twin(port_model, jax_model), pj)
    ModuleSerializer.save(port_model, pt)
    with open(pj, "rb") as f:
        j = pb2.ModelProto.FromString(f.read())
    with open(pt, "rb") as f:
        t = pb2.ModelProto.FromString(f.read())
    return j, t


def _leaves(mp):
    return [(nt.path, list(nt.tensor.shape), nt.tensor.dtype,
             nt.tensor.storage_id) for nt in list(mp.parameters)
            + list(mp.state)]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_both_packages_write_the_same_file(name, tmp_path):
    j, t = _files(_port(name), MODELS[name][1](), tmp_path)
    assert _diff_trees(j.module, t.module) == []
    assert j.framework_version == t.framework_version
    assert _leaves(j) == _leaves(t)
    assert [hashlib.sha256(s.data).hexdigest() for s in j.storages] == \
        [hashlib.sha256(s.data).hexdigest() for s in t.storages]


def test_inception_v2_trees_differ_only_by_the_recorded_ceil_mode(tmp_path):
    port = tm.Inception_v2_NoAuxClassifier(1000, device="cpu").eval()
    _randomize_bn(port)
    j, t = _files(port, jm.Inception_v2_NoAuxClassifier(1000), tmp_path)
    diffs = _diff_trees(j.module, t.module)
    assert diffs  # the pools' ceil mode, and nothing else
    for where, field, a, b in diffs:
        assert field == "ctor_kwargs[ceil_mode]", (where, field)
        assert a is None and b == pb2.AttrValue(b=True), where
        assert where.split("/")[-1].split("_", 1)[1] in (
            "SpatialMaxPooling", "SpatialAveragePooling"), where
    assert len(diffs) == 13  # the stem's 2, one a block (10), the head's
    assert _leaves(j) == _leaves(t)
    # a name holding "/" ("conv1/7x7_s2") keeps its place in the port: the
    # reference's file loads with no dropped leaf, its pools in floor
    # mode as the file says
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        loaded = ModuleSerializer.load(str(tmp_path / "j.bigdl"),
                                       device="cpu")
    assert not loaded.get_submodule("1_SpatialMaxPooling").ceil_mode
    stem = loaded.get_submodule("0_Sequential.0_conv1/7x7_s2")
    torch.testing.assert_close(stem.weight, port.get_submodule(
        "0_Sequential.0_conv1/7x7_s2").weight, rtol=0, atol=0)
    # the port's own file keeps the mode, and the function
    mine = ModuleSerializer.load(str(tmp_path / "t.bigdl"), device="cpu")
    assert mine.get_submodule("1_SpatialMaxPooling").ceil_mode
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 224, 224, 3)
                         .astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(mine.eval()(x), port.eval()(x), rtol=0,
                                   atol=0)
