"""Port parity: the sharding rules (`bigdl_tpu_torch.parallel.sharding`)
and the sharded checkpoints (`serialization/sharded_checkpoint.py`) in one
process, against `bigdl_tpu`.

- `infer_param_specs` of a port model equals the reference's on the JAX
  model's parameter tree, spec for spec, for `TransformerLM(512, 256, 1,
  4)` (as `tests/test_determinism.py` uses it), the model of
  `tests/test_tp_parity.py`, its embedding model and CIFAR ResNet-8, at
  model axes 1, 2 and 4 and `min_shard_dim` 16, 128 and 256; the JAX
  shapes come from `jax.eval_shape` (no init runs).
- `param_specs` translates a conv kernel's HWIO spec to the port's OIHW,
  and `shard_params` slices each parameter where its spec says.
- `save_sharded` / `restore_sharded` round-trip a tree at world size 1
  (DCP's no-dist mode), empty subtrees and integer leaves included.
- `set_checkpoint(sharded=True)` on `LocalOptimizer`: k steps, a new
  optimizer resumed from the checkpoint and N-k more steps equal N
  uninterrupted steps bit for bit; `keep_last_n` prunes and
  `latest_checkpoint` finds the sharded directories.
- The documents (`optim.json`, `manifest.json`) carry the keys the JAX
  package writes for the same run.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset.dataset import LocalDataSet as JLocalDataSet
from bigdl_tpu.dataset.sample import MiniBatch as JMiniBatch
from bigdl_tpu.models.resnet import ResNet as JResNet
from bigdl_tpu.models.transformer import TransformerLM as JTransformerLM
from bigdl_tpu.optim.local_optimizer import LocalOptimizer as JLocal
from bigdl_tpu.parallel.mesh import build_mesh as jbuild_mesh
from bigdl_tpu.parallel.sharding import ShardingRules as JRules
from bigdl_tpu.parallel.sharding import infer_param_specs as jinfer
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
from bigdl_tpu_torch.interop import module_params_tree
from bigdl_tpu_torch.models import ResNet as TResNet
from bigdl_tpu_torch.models import TransformerLM as TTransformerLM
from bigdl_tpu_torch.optim.optimizer import _as_batched_dataset
from bigdl_tpu_torch.parallel import build_mesh
from bigdl_tpu_torch.parallel.sharding import (PartitionSpec, ShardingRules,
                                               infer_param_specs,
                                               param_specs, shard_params)
from bigdl_tpu_torch.serialization import checkpoint as tckpt
from bigdl_tpu_torch.serialization import sharded_checkpoint as tsc


def _tp_parity_model(nn, **kw):
    """`tests/test_tp_parity.py`'s model, dropout and conv bias included."""
    return (nn.Sequential()
            .add(nn.SpatialConvolution(3, 8, 3, 3, pad_w=1, pad_h=1, **kw))
            .add(nn.SpatialBatchNormalization(8, **kw))
            .add(nn.ReLU())
            .add(nn.Reshape((8 * 8 * 8,)))
            .add(nn.Linear(8 * 8 * 8, 256, **kw))
            .add(nn.ReLU())
            .add(nn.Dropout(0.2))
            .add(nn.Linear(256, 4, **kw))
            .add(nn.LogSoftMax()))


def _embedding_model(nn, **kw):
    """`tests/test_tp_parity.py`'s embedding model."""
    return (nn.Sequential()
            .add(nn.LookupTable(512, 16, **kw))
            .add(nn.Mean(dimension=1))
            .add(nn.Linear(16, 4, **kw))
            .add(nn.LogSoftMax()))


MODELS = {
    "transformer_lm": (lambda: JTransformerLM(512, 256, 1, 4),
                       lambda: TTransformerLM(512, 256, 1, 4,
                                              device="meta")),
    "tp_parity": (lambda: _tp_parity_model(jnn),
                  lambda: _tp_parity_model(tnn, device="meta")),
    "embedding": (lambda: _embedding_model(jnn),
                  lambda: _embedding_model(tnn, device="meta")),
    "resnet8": (lambda: JResNet(10, depth=8, data_set="cifar10"),
                lambda: TResNet(10, depth=8, data_set="cifar10",
                                device="meta")),
}


@pytest.fixture(scope="module")
def model_pairs():
    """{name: (the JAX model's parameter shapes, the port model)}."""
    out = {}
    for name, (jbuild, tbuild) in MODELS.items():
        with jax.ensure_compile_time_eval():
            shapes = jax.eval_shape(jbuild().init, jax.random.PRNGKey(0))
        out[name] = (shapes, tbuild())
    return out


def _as_tuples(specs):
    return jax.tree_util.tree_map(
        tuple, specs, is_leaf=lambda s: isinstance(s, tuple)
        or type(s).__name__ == "PartitionSpec")


@pytest.mark.parametrize("min_shard_dim", [16, 128, 256])
@pytest.mark.parametrize("model_axis", [1, 2, 4])
@pytest.mark.parametrize("name", list(MODELS))
def test_specs_equal_the_reference(model_pairs, name, model_axis,
                                   min_shard_dim):
    shapes, model = model_pairs[name]
    jmesh = jbuild_mesh(data=1, model=model_axis,
                        devices=jax.devices()[:model_axis])
    want = _as_tuples(jinfer(shapes, jmesh, JRules(min_shard_dim)))
    mesh = build_mesh(data=1, model=model_axis, devices=["cpu"] * model_axis)
    got = infer_param_specs(model, mesh, ShardingRules(min_shard_dim))
    assert _as_tuples(got) == want
    # the port-layout specs: one a parameter, sharded where the
    # reference's are
    port = param_specs(model, mesh, ShardingRules(min_shard_dim))
    assert set(port) == {n for n, _ in model.named_parameters()}
    n_sharded = sum("model" in s for s in
                    jax.tree_util.tree_leaves(_as_tuples(got),
                                              is_leaf=lambda s:
                                              isinstance(s, tuple)))
    assert sum("model" in s for s in port.values()) == n_sharded
    if model_axis > 1 and min_shard_dim == 16:
        assert n_sharded > 0


def test_conv_spec_moves_from_hwio_to_oihw():
    torch.manual_seed(0)
    model = (tnn.Sequential()
             .add(tnn.SpatialConvolution(3, 32, 3, 3, device="cpu"))
             .add(tnn.ReLU()))
    mesh = build_mesh(data=1, model=2, devices=["cpu", "cpu"])
    rules = ShardingRules(min_shard_dim=16)
    ref = infer_param_specs(model, mesh, rules)
    assert ref["0_SpatialConvolution"]["weight"] == \
        PartitionSpec(None, None, None, "model")
    specs = param_specs(model, mesh, rules)
    assert specs == {"0_SpatialConvolution.weight":
                     PartitionSpec("model", None, None, None),
                     "0_SpatialConvolution.bias": PartitionSpec()}
    hwio = module_params_tree(model)["0_SpatialConvolution"]["weight"]
    for index in (0, 1):
        shards, _ = shard_params(model, mesh, rules, index=index)
        w = shards["0_SpatialConvolution.weight"]
        assert tuple(w.shape) == (16, 3, 3, 3)
        # the port's shard is the reference's HWIO shard, permuted
        np.testing.assert_array_equal(
            w.permute(2, 3, 1, 0).numpy(),
            hwio[..., 16 * index:16 * (index + 1)])


def test_shard_params_slices_where_the_spec_says():
    model = TTransformerLM(64, 32, 1, 4, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    mesh = build_mesh(data=1, model=2, devices=["cpu", "cpu"])
    rules = ShardingRules(min_shard_dim=16)
    parts = [shard_params(model, mesh, rules, index=i) for i in (0, 1)]
    specs = parts[0][1]
    assert specs["embed"] == PartitionSpec("model", None)
    assert specs["head"] == PartitionSpec(None, "model")
    assert specs["blocks.0.attn.wq"] == PartitionSpec(None, "model")
    assert specs["blocks.0.ln1.weight"] == PartitionSpec()
    for name, p in model.named_parameters():
        spec = specs[name]
        if "model" not in spec:
            assert parts[0][0][name].data_ptr() == p.data_ptr()
            continue
        dim = spec.index("model")
        assert parts[0][0][name].shape[dim] == p.shape[dim] // 2
        torch.testing.assert_close(
            torch.cat([parts[0][0][name], parts[1][0][name]], dim), p,
            rtol=0, atol=0)


def test_save_and_restore_sharded_in_one_process(tmp_path):
    rs = np.random.RandomState(0)
    tree = {"params": {"a": {"w": torch.from_numpy(rs.rand(4, 6)
                                                   .astype(np.float32)),
                             "b": rs.rand(6).astype(np.float32)},
                       "relu": {}},
            "slots": {"step": np.asarray(3, np.int32),
                      "v": {"w": torch.ones(4, 6, dtype=torch.bfloat16)}}}
    path = tsc.save_sharded(str(tmp_path / "arrays"), tree)
    assert os.path.isabs(path) and os.path.exists(
        os.path.join(path, ".metadata"))
    like = {"params": {"a": {"w": torch.zeros(4, 6), "b": np.zeros(6,
                                                                   np.float32)},
                       "relu": {}},
            "slots": {"step": np.asarray(0, np.int32),
                      "v": {"w": torch.zeros(4, 6, dtype=torch.bfloat16)}}}
    got = tsc.restore_sharded(path, like)
    assert got["params"]["relu"] == {}
    assert torch.equal(got["params"]["a"]["w"], tree["params"]["a"]["w"])
    np.testing.assert_array_equal(got["params"]["a"]["b"].numpy(),
                                  tree["params"]["a"]["b"])
    assert int(got["slots"]["step"]) == 3
    assert got["slots"]["v"]["w"].dtype == torch.bfloat16
    # as saved: the structure (the empty subtree too), numpy leaves
    saved = tsc._map(tsc._read_as_saved(path), tsc._host)
    assert saved["params"]["relu"] == {}
    assert saved["slots"]["step"].dtype == np.int32
    assert saved["slots"]["v"]["w"].dtype == np.float32
    with pytest.raises(ValueError, match="local path"):
        tsc.save_sharded("memory://x", tree)


def _data(n=40, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.rand(n, 16, 16, 3).astype(np.float32)
    y = (rs.randint(0, 10, n) + 1).astype(np.int32)
    return x, y


N_STEPS, K = 14, 9  # 5 batches an epoch: the checkpoint sits mid-epoch 2


def _resumable(path, seed=0):
    x, y = _data()
    tm = TResNet(10, depth=8, data_set="cifar10", device="cpu",
                 generator=torch.Generator().manual_seed(seed))
    opt = toptim.LocalOptimizer(tm, _as_batched_dataset((x, y), 8, False),
                                tnn.ClassNLLCriterion(), device="cpu")
    opt.set_optim_method(toptim.SGD(0.1, momentum=0.9))
    opt.set_checkpoint(str(path), toptim.several_iteration(3), sharded=True,
                       keep_last_n=2)
    opt.set_end_when(toptim.max_iteration(N_STEPS))
    losses = []
    opt.set_iteration_hook(lambda s: losses.append(s["loss"]))
    return tm, opt, losses


def test_local_sharded_checkpoint_resumes_bitwise_and_prunes(tmp_path):
    tm, opt, full = _resumable(tmp_path / "a")
    opt.optimize()
    assert [os.path.basename(p) for p in tckpt.valid_checkpoints(
        str(tmp_path / "a"))] == ["iter12", "iter9"]
    latest = tckpt.latest_checkpoint(str(tmp_path / "a"))
    assert os.path.basename(latest) == "iter12"
    assert sorted(os.listdir(latest)) == ["arrays", "manifest.json",
                                          "optim.json"]
    assert not [d for d in os.listdir(tmp_path / "a") if d.startswith(".")]
    shutil.copytree(tmp_path / "a" / f"iter{K}", tmp_path / "b" / f"iter{K}")
    tm2, opt2, rest = _resumable(tmp_path / "b", seed=5)
    assert opt2.resume_from_latest_checkpoint()
    opt2.optimize()
    assert rest == full[K:]
    for (k, a), b in zip(tm.state_dict().items(), tm2.state_dict().values()):
        assert torch.equal(a, b), k
    assert opt2.optim_method.state["epoch"] == opt.optim_method.state["epoch"]


def _mlp(nn, **kw):
    return (nn.Sequential().add(nn.Linear(6, 5, **kw))
            .add(nn.LogSoftMax()))


def test_documents_carry_the_reference_keys(tmp_path):
    rs = np.random.RandomState(1)
    x = rs.randn(8, 6).astype(np.float32)
    y = (rs.randint(0, 5, 8) + 1).astype(np.int32)
    jm = _mlp(jnn)
    jm.ensure_params()
    jopt = JLocal(jm, JLocalDataSet([JMiniBatch(x, y)]),
                  jnn.ClassNLLCriterion())
    jopt.set_optim_method(joptim.SGD(learning_rate=0.1, momentum=0.9))
    jopt.set_end_when(joptim.max_iteration(2))
    jopt.set_checkpoint(str(tmp_path / "jax"), joptim.several_iteration(2),
                        sharded=True)
    jopt.optimize()
    tm = _mlp(tnn, device="cpu")
    topt = toptim.LocalOptimizer(tm, LocalDataSet([MiniBatch(x, y)]),
                                 tnn.ClassNLLCriterion(), device="cpu")
    topt.set_optim_method(toptim.SGD(learning_rate=0.1, momentum=0.9))
    topt.set_end_when(toptim.max_iteration(2))
    topt.set_checkpoint(str(tmp_path / "port"), toptim.several_iteration(2),
                        sharded=True)
    topt.optimize()
    for doc in ("optim.json", "manifest.json"):
        with open(tmp_path / "jax" / "iter2" / doc) as f:
            want = json.load(f)
        with open(tmp_path / "port" / "iter2" / doc) as f:
            got = json.load(f)
        assert set(got) == set(want), doc
        if doc == "optim.json":
            assert set(got["state"]) == set(want["state"])
            assert got["state"]["neval"] == want["state"]["neval"] == 2
            assert got["class"] == want["class"]
            assert got["state_array_keys"] == want["state_array_keys"]
            # the reference's SGD also keeps its private `_clr`
            assert {k for k in want["hyper"] if not k.startswith("_")} == \
                set(got["hyper"])
        else:
            assert (got["format"], got["tag"], got["sharded"]) == \
                (want["format"], want["tag"], want["sharded"])
    # the sharded directories load in the port's resume scan
    params, _, blob = tckpt.load_latest_valid(str(tmp_path / "port"))[1:]
    assert params["0_Linear"]["weight"].shape == (6, 5)
    assert blob["slots"]["velocity"]["0_Linear"]["weight"].shape == (6, 5)
