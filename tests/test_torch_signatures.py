"""Port parity of call signatures: a positional call that builds a layer,
a model, an optimizer or an attention call in `bigdl_tpu` builds the same
thing in `bigdl_tpu_torch`.

`test_positional_parameters_match_the_reference` walks every public class
and function that both packages define in the same module path and
asserts that the port's positional parameter names are a prefix of the
reference's, once the reference's TPU tunings (block and tile sizes,
`interpret`, `use_pallas`) are set aside. A parameter the port adds
(`device`, `generator`, `devices`, `inplace`, the attention offsets) is
keyword-only. `EXEMPT` lists what differs by design, each with its reason.

The parity cases below hold the repaired classes to the reference on the
same inputs (numpy, fixed seeds): outputs within 1e-6 (the same f32
arithmetic) unless stated.
"""

import importlib
import importlib.util
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.nn.module import functional_apply
import bigdl_tpu_torch
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.dataset import LocalDataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.ir import ConversionUtils
from bigdl_tpu_torch.models import ResNet
from bigdl_tpu_torch.ops import attention_kernel as tak
from bigdl_tpu_torch.optim import DistriOptimizer, LocalOptimizer
from bigdl_tpu_torch.parallel import build_mesh

#: the reference's TPU tunings, which the port does not take
TUNINGS = {"block_q", "block_k", "tile_n", "tile_h", "tile_w", "interpret",
           "use_pallas"}

#: "module.name" -> why its positional parameters differ by design
EXEMPT = {
    "bigdl_tpu_torch.parallel.sequence.ring_attention":
        "single-controller: takes the shards of q, k, v over a Mesh and "
        "no axis_name; the reference runs per shard inside shard_map",
    "bigdl_tpu_torch.parallel.sequence.zigzag_ring_attention":
        "single-controller, as ring_attention",
    "bigdl_tpu_torch.parallel.sequence.ulysses_attention":
        "single-controller, as ring_attention",
    "bigdl_tpu_torch.parallel.mesh.Mesh":
        "an array of torch devices; the reference's is jax.sharding.Mesh",
    "bigdl_tpu_torch.serving.generation.greedy_decode_reference":
        "the torch model holds its own parameters: no params argument, and "
        "no jit padding or forward function",
}


def _port_modules():
    """(port module, reference module) names of every port module whose
    path the reference also has."""
    pairs = []
    for info in pkgutil.walk_packages(bigdl_tpu_torch.__path__,
                                      "bigdl_tpu_torch."):
        ref = "bigdl_tpu" + info.name[len("bigdl_tpu_torch"):]
        try:
            found = importlib.util.find_spec(ref) is not None
        except ModuleNotFoundError:  # its parent package is port-only
            found = False
        if found:
            pairs.append((info.name, ref))
    return sorted(pairs)


PAIRS = _port_modules()


def _positional(obj):
    params = inspect.signature(obj).parameters.values()
    return [p.name for p in params
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
            and p.name != "self" and p.name not in TUNINGS]


def _public(module):
    """Public classes and functions that `module` itself defines
    (exceptions aside: they take their message)."""
    return {name: obj for name, obj in vars(module).items()
            if not name.startswith("_")
            and (inspect.isfunction(obj) or (
                inspect.isclass(obj)
                and not issubclass(obj, BaseException)))
            and obj.__module__ == module.__name__}


def test_the_walk_sees_the_ported_modules():
    names = {p for p, _ in PAIRS}
    assert {"bigdl_tpu_torch.nn.normalization", "bigdl_tpu_torch.nn.pooling",
            "bigdl_tpu_torch.optim.distri_optimizer",
            "bigdl_tpu_torch.ops.attention_kernel",
            "bigdl_tpu_torch.nn.quantized",
            "bigdl_tpu_torch.tensor.quantized"} <= names


#: (module path under both packages, class, method) of the quantization
#: API's methods, which the class walk above does not reach
QUANT_METHODS = [
    ("nn.quantized", "QuantizedLinear", "from_float"),
    ("nn.quantized", "QuantizedSpatialConvolution", "from_float"),
    ("nn.quantized", "WeightOnlyQuantizedLinear", "from_float"),
    ("nn.quantized", "WeightOnlyQuantizedSpatialConvolution", "from_float"),
    ("nn.quantized", "Quantizer", "quantize"),
    ("nn.module", "Module", "quantize"),
    ("tensor.quantized", "QuantizedTensor", "from_float"),
    ("tensor.quantized", "QuantizedTensor", "matmul_t"),
]


@pytest.mark.parametrize("path,cls,method", QUANT_METHODS,
                         ids=[f"{c}.{m}" for _, c, m in QUANT_METHODS])
def test_quantization_methods_take_the_reference_positionals(path, cls,
                                                             method):
    """`from_float(module, params)` keeps the reference's positional
    `params` (None: the module's own), `quantize(module, weight_only)`
    and the tensor's methods theirs."""
    port, ref = (getattr(importlib.import_module(f"{pkg}.{path}"), cls)
                 for pkg in ("bigdl_tpu_torch", "bigdl_tpu"))
    assert _positional(getattr(port, method)) == \
        _positional(getattr(ref, method))


@pytest.mark.parametrize("port_name,ref_name", PAIRS,
                         ids=[p for p, _ in PAIRS])
def test_positional_parameters_match_the_reference(port_name, ref_name):
    port, ref = (importlib.import_module(n) for n in (port_name, ref_name))
    refs = _public(ref)
    wrong = []
    for name, obj in _public(port).items():
        if name not in refs or f"{port_name}.{name}" in EXEMPT:
            continue
        got, want = _positional(obj), _positional(refs[name])
        if got != want[:len(got)]:
            wrong.append(f"{name}: port {got}, reference {want}")
    assert not wrong, "\n".join(wrong)


@pytest.mark.parametrize("key", sorted(EXEMPT))
def test_each_exemption_names_what_both_packages_have(key):
    port_name, name = key.rsplit(".", 1)
    ref_name = "bigdl_tpu" + port_name[len("bigdl_tpu_torch"):]
    assert name in _public(importlib.import_module(port_name))
    assert hasattr(importlib.import_module(ref_name), name)
    assert EXEMPT[key]


# ---------------------------------------------------------------- parity


def test_class_nll_takes_probabilities_positionally():
    """logProbAsInput=False, third: the reference's -log p of the targets,
    averaged (0.4338 on this data)."""
    p = np.array([[0.7, 0.2, 0.1], [0.1, 0.6, 0.3]], np.float32)
    t = np.array([1, 2])
    want = float(jnn.ClassNLLCriterion(None, True, False)(jnp.asarray(p),
                                                          jnp.asarray(t)))
    got = float(tnn.ClassNLLCriterion(None, True, False)(torch.from_numpy(p),
                                                         torch.from_numpy(t)))
    assert round(want, 4) == 0.4338
    assert abs(got - want) <= 1e-6


def test_class_nll_zero_based_is_fourth():
    logp = np.log(np.array([[0.7, 0.2, 0.1], [0.1, 0.6, 0.3]], np.float32))
    t = np.array([0, 1])
    want = float(jnn.ClassNLLCriterion(None, False, True, True)(
        jnp.asarray(logp), jnp.asarray(t)))
    got = float(tnn.ClassNLLCriterion(None, False, True, True)(
        torch.from_numpy(logp), torch.from_numpy(t)))
    assert abs(got - want) <= 1e-6


@pytest.mark.parametrize("spatial", [False, True])
def test_batchnorm_without_affine_positionally(spatial):
    """affine=False, fourth: no parameters in either package; the same
    normalized output and running statistics in training mode."""
    shape = (4, 3, 3, 5) if spatial else (6, 5)
    x = np.random.RandomState(0).randn(*shape).astype(np.float32) * 2 + 1
    name = "SpatialBatchNormalization" if spatial else "BatchNormalization"
    jcls, tcls = getattr(jnn, name), getattr(tnn, name)
    j = jcls(5, 1e-5, 0.1, False)
    t = tcls(5, 1e-5, 0.1, False, device="cpu")
    assert j.init(jax.random.PRNGKey(0)) == {}
    assert list(t.parameters()) == []
    out_j, new = functional_apply(j, {}, jnp.asarray(x), training=True)
    out_t = t.train()(torch.from_numpy(x))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-6)
    (state,) = new.values()
    np.testing.assert_allclose(t.mean.numpy(), np.asarray(state["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(t.var.numpy(), np.asarray(state["var"]),
                               atol=1e-6)


def test_batchnorm_without_affine_folds_into_its_convolution():
    """The inference fold takes a BN without the affine as gamma 1, beta
    0 (as the reference's): the folded model gives the eval output within
    1e-5 (the fold is in f64, the BN in f32)."""
    g = torch.Generator().manual_seed(0)
    m = (tnn.Sequential()
         .add(tnn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1, device="cpu",
                                     generator=g))
         .add(tnn.SpatialBatchNormalization(4, 1e-5, 0.1, False,
                                            device="cpu")))
    bn = list(m.children())[1]
    with torch.no_grad():
        bn.mean.copy_(torch.tensor([0.5, -0.2, 0.1, 0.0]))
        bn.var.copy_(torch.tensor([2.0, 0.5, 1.5, 1.0]))
    x = torch.from_numpy(
        np.random.RandomState(1).randn(2, 6, 6, 3).astype(np.float32))
    want = m.eval()(x)
    folded = ConversionUtils.convert(m)
    assert not any(isinstance(c, tnn.SpatialBatchNormalization)
                   for c in folded.modules())
    torch.testing.assert_close(folded.eval()(x), want, atol=1e-5, rtol=0)


def test_spatial_batchnorm_data_format_and_name_positionally():
    t = tnn.SpatialBatchNormalization(5, 1e-5, 0.1, True, "NHWC", "bn",
                                      device="cpu")
    assert t.name == "bn" and t.weight is not None
    with pytest.raises(NotImplementedError, match="NCHW"):
        tnn.SpatialBatchNormalization(5, 1e-5, 0.1, True, "NCHW")


def test_layer_norm_name_is_third():
    x = np.random.RandomState(2).randn(3, 8).astype(np.float32)
    j = jnn.LayerNormalization(8, 1e-3, "ln")
    t = tnn.LayerNormalization(8, 1e-3, "ln", device="cpu")
    assert t.name == j.name == "ln"
    params = j.init(jax.random.PRNGKey(0))
    out_j, _ = functional_apply(j, params, jnp.asarray(x))
    torch.testing.assert_close(t(torch.from_numpy(x)),
                               torch.from_numpy(np.array(out_j)),
                               atol=1e-6, rtol=0)


def test_convolution_data_format_is_thirteenth():
    args = (3, 4, 3, 3, 1, 1, 1, 1, 1, True, None, None)
    assert tnn.SpatialConvolution(*args, "NHWC", "conv",
                                  device="cpu").name == "conv"
    with pytest.raises(NotImplementedError, match="NCHW"):
        tnn.SpatialConvolution(*args, "NCHW", device="cpu")


def test_max_pool_data_format_is_eighth():
    x = np.random.RandomState(3).randn(2, 7, 7, 3).astype(np.float32)
    j = jnn.SpatialMaxPooling(3, 3, 2, 2, 1, 1, True, "NHWC", "pool")
    t = tnn.SpatialMaxPooling(3, 3, 2, 2, 1, 1, True, "NHWC", "pool")
    assert t.name == "pool"
    np.testing.assert_array_equal(t(torch.from_numpy(x)).numpy(),
                                  np.asarray(j.forward(jnp.asarray(x))))
    with pytest.raises(NotImplementedError, match="NCHW"):
        tnn.SpatialMaxPooling(3, 3, 2, 2, 1, 1, True, "NCHW")


@pytest.mark.parametrize("args", [
    (2, 2),                                     # the CIFAR shortcut's use
    (3, 3, 2, 2, 1, 1),                         # padding, counted
    (3, 3, 2, 2, 1, 1, False, False),           # padding, not counted
    (3, 3, 2, 2, 1, 1, True, True),             # ceil mode, counted
    (3, 3, 2, 2, 0, 0, True, False),            # ceil mode, not counted
    (3, 3, 2, 2, 1, 1, False, True, False),     # the sum
    (3, 3, 2, 2, -1, -1),                       # SAME
    (2, 3, 1, 2, 1, 1, True, True, True, "NHWC", "avg"),
])
def test_average_pool_matches_the_reference(args):
    """Padding, ceil mode, count_include_pad and divide, positionally, on
    a ragged 7x8 input; within 1e-6 (the same sums in another order)."""
    x = np.random.RandomState(4).randn(2, 7, 8, 3).astype(np.float32)
    want = np.asarray(jnn.SpatialAveragePooling(*args).forward(
        jnp.asarray(x)))
    got = tnn.SpatialAveragePooling(*args)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_average_pool_rejects_nchw():
    with pytest.raises(NotImplementedError, match="NCHW"):
        tnn.SpatialAveragePooling(2, 2, 2, 2, 0, 0, False, True, True,
                                  "NCHW")


def test_resnet_remat_is_sixth_and_s2d_stem_seventh():
    m = ResNet(10, 18, "B", "ImageNet", True, True, device="cpu")
    assert sum(isinstance(c, tnn.Remat) for c in m.modules()) == 8
    m = ResNet(10, 18, "B", "ImageNet", True, False, True, device="cpu")
    assert any(isinstance(c, tnn.SpaceToDepthStemConvolution)
               for c in m.modules())


def test_sample_to_minibatch_paddings_come_before_drop_remainder():
    samples = [Sample(np.full(2, i, np.float32), np.int64(i))
               for i in range(5)]
    got = list(SampleToMiniBatch(2, None, None, True)(iter(samples)))
    assert [len(b.get_input()) for b in got] == [2, 2]
    # the paddings, second and third, pad ragged records as the
    # reference's do
    from bigdl_tpu.dataset import SampleToMiniBatch as JSampleToMiniBatch
    from bigdl_tpu.dataset.sample import PaddingParam as JPaddingParam
    from bigdl_tpu_torch.dataset import PaddingParam
    ragged = [np.arange(n, dtype=np.float32) for n in (2, 3)]
    got = next(SampleToMiniBatch(2, PaddingParam(-1.0, 5), None, True)(
        iter([Sample(r, np.int64(1)) for r in ragged])))
    want = next(JSampleToMiniBatch(2, JPaddingParam(-1.0, 5), None,
                                   True).apply(
        iter([JSample(r, np.int64(1)) for r in ragged])))
    np.testing.assert_array_equal(got.get_input(), want.get_input())
    assert got.get_input().shape == (2, 5)
    # the reference keeps the tail batch unless drop_remainder
    from bigdl_tpu.dataset import SampleToMiniBatch as JSampleToMiniBatch
    jsamples = [JSample(np.full(2, i, np.float32), np.int64(i))
                for i in range(5)]
    assert len(list(JSampleToMiniBatch(2, None, None, False).apply(
        iter(jsamples)))) == 3 == len(list(
            SampleToMiniBatch(2, None, None, False)(iter(samples))))


def test_local_dataset_seed_is_second():
    items = list(range(8))

    def first_pass(ds):
        it = ds.data(train=True)
        return [next(it) for _ in items]

    assert first_pass(LocalDataSet(items, 5)) == first_pass(
        LocalDataSet(items, generator=torch.Generator().manual_seed(5)))


def test_optimizers_take_the_reference_positions():
    model = ResNet(10, depth=8, data_set="cifar10", device="cpu")
    crit = tnn.ClassNLLCriterion()
    ds = LocalDataSet([])
    one = DistriOptimizer(model, ds, crit, build_mesh(devices=["cpu"]))
    assert [str(d) for d in one.devices] == ["cpu"]
    two = DistriOptimizer(model, ds, crit, build_mesh(devices=["cpu"] * 2))
    assert len(two.devices) == 2  # elastic mode's device list
    with pytest.raises(NotImplementedError, match="one process per GPU"):
        two.optimize()
    with pytest.raises(ValueError, match="not both"):
        DistriOptimizer(model, ds, crit, build_mesh(devices=["cpu"]),
                        devices=["cpu"])
    assert LocalOptimizer(model, ds, crit, 16, device="cpu").batch_size == 16
    with pytest.raises(TypeError):
        LocalOptimizer(model, ds, crit, 16, "cpu")


#: methods of the elastic and preemption slice, ("module", "Class",
#: "method"), whose positional parameters equal the reference's (the walk
#: above compares constructors and functions only)
METHODS = [
    ("optim.distri_optimizer", "DistriOptimizer", m)
    for m in ("set_elastic", "set_gradient_bucketing")] + [
    ("optim.local_optimizer", "BaseOptimizer", "set_preemption_handler")] + [
    ("resilience.membership", "WorkerRegistry", m)
    for m in ("register", "heartbeat", "mark_lost", "mark_device_lost",
              "remove", "sweep", "worker_for_device", "snapshot")] + [
    ("resilience.membership", "SimulatedCluster", m)
    for m in ("fail", "restore", "shard")] + [
    ("resilience.elastic", "ElasticController", m)
    for m in ("plan", "shard_device", "replay_boundary", "split_batch")] + [
    ("resilience.preemption", "PreemptionHandler", m)
    for m in ("install", "uninstall", "deadline_remaining", "reset")]


@pytest.mark.parametrize("module,cls,method", METHODS,
                         ids=[".".join(m) for m in METHODS])
def test_elastic_methods_take_the_reference_positions(module, cls, method):
    port, ref = (getattr(getattr(importlib.import_module(f"{pkg}.{module}"),
                                 cls), method)
                 for pkg in ("bigdl_tpu_torch", "bigdl_tpu"))
    assert _positional(port) == _positional(ref)


def test_attention_port_only_parameters_are_keywords():
    rs = np.random.RandomState(5)
    q, k, v, g = (torch.from_numpy(rs.randn(1, 2, 16, 8).astype(np.float32))
                  for _ in range(4))
    out, lse = tak.flash_attention_forward(q, k, v, True, None, True)
    got = tak.flash_attention_backward(q, k, v, out=out, lse=lse, g=g,
                                       causal=True)
    want = tak.flash_attention_backward_plain(q, k, v, out, lse, g, True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    carry = tak.attention_state_init(q)
    with pytest.raises(TypeError):
        tak.flash_attention_carry(q, k, v, carry, True, None, 0, 0, True)
    with pytest.raises(TypeError):
        tak.flash_attention_forward(q, k, v, True, None, True, 16)


def test_distributed_dataset_takes_the_reference_positions():
    """`DistributedDataSet(items, host_index, num_hosts, seed)` and
    `DataSet.array(items, host_index, num_hosts)`, positionally, shard as
    the reference's do: item i on host i % num_hosts."""
    from bigdl_tpu.dataset.dataset import DataSet as JDataSet
    from bigdl_tpu.dataset.dataset import DistributedDataSet as JDistributed
    from bigdl_tpu_torch.dataset import DataSet, DistributedDataSet
    assert _positional(DistributedDataSet) == _positional(JDistributed)
    assert _positional(DataSet.array) == _positional(JDataSet.array)
    items = list(range(7))
    for args in ((0, 3, 5), (2, 3, 5), (1, 2)):
        got, want = DistributedDataSet(items, *args), JDistributed(items,
                                                                   *args)
        assert (got.items, got.size(), got.global_size, got.host_index,
                got.num_hosts) == (want.items, want.size(),
                                   want.global_size, want.host_index,
                                   want.num_hosts)
    assert DataSet.array(items, 1, 2).items == \
        JDataSet.array(items, 1, 2).items
