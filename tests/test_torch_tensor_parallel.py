"""Port parity: tensor parallelism (`DistriOptimizer` on a (data, model)
`ProcessMesh` of gloo ranks on the CPU, one process a rank) and sharded
checkpoints through `torch.distributed.checkpoint`, against the JAX
`DistriOptimizer` on `build_mesh(data=2, model=2)` and against the port's
own data-parallel run.

A rank script (`_RANK_SCRIPT`) runs in real processes, as in
`tests/test_torch_distributed.py`. Three launches serve the file:
- `tp` (4 ranks, mesh (2, 2)): every scenario of one healthy run (plain
  with a sharded checkpoint at step 2, observed by a telemetry with the
  gradient norms and a skipping NaN guard, with L2 clipping, under LAMB, with
  a format v2 checkpoint at step 2, with the conv split too and its
  sharded checkpoint, with dropout), recording each rank's stored shard
  and slot shapes; a run that fails at step 2; a `DistributedDataSet`
  over the world's ranks, refused;
- `resume` (4 ranks, (2, 2)): a fresh launch resuming from the sharded and
  from the v2 checkpoint, and `restore_sharded` onto the (2, 2) specs;
- `dp` (2 ranks, (2, 1)): the same runs without a model axis, a resume
  and a `restore_sharded` of the (2, 2) sharded checkpoint, and
  `load_latest_valid` where the newest checkpoint fails to read on one
  rank alone.
Each launch has a 120 s limit; each rank pins torch to one thread.

The model is `tests/test_tp_parity.py`'s (conv -> BN -> ReLU -> Reshape ->
Linear(512, 256) -> ReLU -> Linear(256, 4) -> LogSoftMax) under
`ShardingRules(min_shard_dim=128)`, so `Linear(512, 256)`'s weight is
split column-wise over "model"; its dropout is left out of the parity
runs, and its conv has no bias (BN takes out that gradient: in a parity
test its values are noise). Global batch 16 (8 rows a data replica), SGD
(0.05, momentum 0.9), 4 steps, f32, the JAX model's weights carried in.

Tolerances: against the JAX (2, 2) mesh, losses within a relative 1e-5,
parameters and BN running stats within 1e-5 of each tensor's largest
element (XLA splits the next layer's contraction over the model axis, so
its sums run in another order). Against the port's (2, 1): bitwise (the
gathers are concatenations and each rank's gradient slice is the whole
gradient's), except under clipping and LAMB, whose norms sum the
shards' squares in another order: a relative 1e-6. Resumes and restores
are bitwise.
"""

import ast
import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset.dataset import LocalDataSet as JLocalDataSet
from bigdl_tpu.dataset.sample import MiniBatch as JMiniBatch
from bigdl_tpu.optim.distri_optimizer import DistriOptimizer as JDistri
from bigdl_tpu.parallel.mesh import build_mesh as jbuild_mesh
from bigdl_tpu.parallel.sharding import ShardingRules as JRules
from bigdl_tpu.serialization import checkpoint as jckpt
from bigdl_tpu_torch.serialization import sharded_checkpoint as tsc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
CLIP_RTOL = 1e-6
STEPS = 4
LR = 0.05

_COMMON = r'''
import numpy as np

def tp_net(nn, dropout=False, **kw):
    m = (nn.Sequential()
         .add(nn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1, with_bias=False,
                                    **kw))
         .add(nn.SpatialBatchNormalization(8, **kw))
         .add(nn.ReLU())
         .add(nn.Reshape((8 * 8 * 8,)))
         .add(nn.Linear(8 * 8 * 8, 256, **kw))
         .add(nn.ReLU()))
    if dropout:
        m.add(nn.Dropout(0.2))
    return m.add(nn.Linear(256, 4, **kw)).add(nn.LogSoftMax())

def tp_data():
    rs = np.random.RandomState(0)
    x = rs.rand(16, 8, 8, 3).astype(np.float32)
    y = (rs.randint(0, 4, size=16) + 1).astype(np.int32)
    return x, y
'''
exec(_COMMON)

_RANK_SCRIPT = r'''
import json, os, pickle, shutil, sys, traceback
sys.path.insert(0, os.environ["REPO_ROOT"])
import numpy as np
import torch
torch.set_num_threads(1)

from bigdl_tpu_torch.utils.engine import Engine
Engine.init(distributed=True, timeout_s=60.0)

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch import optim
from bigdl_tpu_torch.dataset import (DistributedDataSet, LocalDataSet,
                                     MiniBatch)
from bigdl_tpu_torch.interop import (load_module_params, module_params_tree,
                                     module_state)
from bigdl_tpu_torch.parallel import ShardingRules, collectives
from bigdl_tpu_torch.parallel.sharding import infer_param_specs
from bigdl_tpu_torch.serialization import restore_sharded
from bigdl_tpu_torch.serialization.checkpoint import load_latest_valid
from bigdl_tpu_torch.utils import filesystem as fsys

exec(open(os.environ["COMMON"]).read())
STEPS, LR = int(os.environ["STEPS"]), float(os.environ["LR"])
rank, world = collectives.rank(), collectives.world_size()
out_dir, ckpt = os.environ["OUT_DIR"], os.environ["CKPT"]
with open(os.environ["INPUTS"], "rb") as f:
    carried = pickle.load(f)
mesh = Engine.get_mesh(data=2, model=world // 2)
d = mesh.data_index
x, y = tp_data()
rows = slice(8 * d, 8 * d + 8)
RULES = ShardingRules(min_shard_dim=128)


def copy_tree(t):
    if isinstance(t, dict):
        return {k: copy_tree(v) for k, v in t.items()}
    return np.array(t, copy=True)


def model_of():
    m = tp_net(nn, device="cpu")
    load_module_params(m, *carried)
    return m


def optimizer(model, dataset=None, rules=RULES):
    return optim.DistriOptimizer(
        model, dataset or LocalDataSet([MiniBatch(x[rows], y[rows])]),
        nn.ClassNLLCriterion(), mesh=mesh, sharding_rules=rules,
        devices=["cpu"])


def train(model, steps=STEPS, clip=None, ckpt_dir=None, sharded=False,
          resume=False, hook=None, rules=RULES, method=None, observe=False):
    opt = optimizer(model, rules=rules)
    sink = None
    if observe:
        from bigdl_tpu_torch.observability import (InMemorySink, NanGuard,
                                                   Telemetry)
        sink = InMemorySink()
        opt.set_telemetry(Telemetry(sink, grad_norms=True, resources=False,
                                    flight=False))
        opt.set_health_monitors(NanGuard("skip"))
    opt.set_optim_method(method or optim.SGD(learning_rate=LR, momentum=0.9))
    opt.set_end_when(optim.max_iteration(steps))
    if clip is not None:
        opt.set_gradient_clipping_by_l2_norm(clip)
    if ckpt_dir is not None:
        opt.set_checkpoint(ckpt_dir, lambda s: s["neval"] == 2,
                           sharded=sharded)
    if resume:
        assert opt.resume_from_latest_checkpoint()
    losses = []

    def on_step(s):
        losses.append(s["loss"])
        if hook is not None:
            hook(opt, s)
    opt.set_iteration_hook(on_step)
    opt.optimize()
    out = {"losses": losses, "params": copy_tree(module_params_tree(model)),
           "state": copy_tree(module_state(model))}
    if sink is not None:
        out["records"] = sink.records
    return out


def shapes(opt, s, into):
    if s["neval"] == 1:
        into["params"] = {n: tuple(p.shape)
                          for n, p in opt.model.named_parameters()}
        into["velocity"] = {n: tuple(v.shape) for n, v in
                            opt.opt_state["velocity"].items()}
        into["sharded"] = sorted(opt.sharded.dims) if opt.sharded else []


def jax_like(tree):
    return {k: jax_like(v) if isinstance(v, dict) else np.zeros_like(v)
            for k, v in tree.items()}


res = {"rank": rank, "world": world, "coords": [d, mesh.model_index]}
scenario = os.environ["SCENARIO"]
try:
    if scenario in ("tp", "dp"):
        collectives.reset_counts()
        stored = {}
        # at (2, 2) the plain run also saves the sharded checkpoint
        res["plain"] = train(model_of(), hook=lambda o, s: shapes(o, s,
                                                                  stored),
                             ckpt_dir=ckpt if scenario == "tp" else None,
                             sharded=True)
        res["plain"]["counts"] = dict(collectives.counts)
        res["plain"]["stored"] = stored
        res["clip"] = train(model_of(), clip=0.05)
        res["observed"] = train(model_of(), observe=True)
        collectives.reset_counts()
        res["lamb"] = train(model_of(),
                            method=optim.LAMB(learning_rate=0.01))
        res["lamb"]["counts"] = dict(collectives.counts)
    if scenario == "tp":
        # a run that fails for good gives the start-of-run weights back
        def fail(o, s):
            if s["neval"] == 2:
                raise RuntimeError("injected at step 2")
        m = model_of()
        try:
            train(m, hook=fail)
            raise AssertionError("the failing run returned")
        except RuntimeError as e:
            assert "injected" in str(e), e
        res["failed"] = {"params": copy_tree(module_params_tree(m)),
                         "state": copy_tree(module_state(m)),
                         "shapes": {n: tuple(p.shape)
                                    for n, p in m.named_parameters()}}
        # a shard over the world's ranks, not the mesh's data replicas
        items = [MiniBatch(x[rows], y[rows])] * 4
        try:
            optimizer(model_of(), DistributedDataSet(items)).optimize()
            res["refused"] = None
        except ValueError as e:
            res["refused"] = str(e)
        optimizer(model_of(), DistributedDataSet(
            items, d, mesh.shape["data"]))._check_dataset()
        res["v2"] = train(model_of(), ckpt_dir=ckpt + "_v2")
        # the conv's 8 output channels split too (OIHW dim 0, HWIO dim 3)
        conv = {}
        res["conv"] = train(model_of(), ckpt_dir=ckpt + "_conv",
                            sharded=True, rules=ShardingRules(8),
                            hook=lambda o, s: shapes(o, s, conv))
        res["conv"]["stored"] = conv
        masks = []
        # the port's own initial weights: rank 0's reach every rank
        m = tp_net(nn, dropout=True, device="cpu")
        m.children_in_order()[6].register_forward_hook(
            lambda mod, i, o: masks.append(np.stack(
                [(i[0] != 0).numpy(), (o != 0).numpy()]).astype(np.uint8)))
        train(m)
        res["masks"] = np.stack(masks)
    elif scenario == "resume":
        res["sharded"] = train(model_of(), ckpt_dir=ckpt, sharded=True,
                               resume=True)
        res["v2"] = train(model_of(), ckpt_dir=ckpt + "_v2", resume=True)
    if scenario in ("resume", "dp"):
        like = module_params_tree(model_of())
        got = restore_sharded(os.path.join(ckpt, "iter2", "arrays"),
                              {"params": like}, mesh,
                              {"params": infer_param_specs(like, mesh,
                                                           RULES)})
        res["restored"] = copy_tree(jax_like(like))
        res["restored_kind"] = {}
        for k, sub in got["params"].items():
            for leaf, t in sub.items():
                res["restored_kind"][f"{k}/{leaf}"] = type(t).__name__
                t = t.to_local() if hasattr(t, "to_local") else t
                res["restored"][k][leaf] = t.numpy().copy()
    if scenario == "dp":
        res["resumed"] = train(model_of(), ckpt_dir=ckpt, sharded=True,
                               resume=True)
        # the newest of two checkpoints fails to read on rank 1 alone: both
        # ranks pass it over and load the older one
        pick = ckpt + "_pick"
        if rank == 0:
            for tag in ("iter2", "iter3"):
                shutil.copytree(os.path.join(ckpt, "iter2"),
                                os.path.join(pick, tag))
            mf = os.path.join(pick, "iter3", "manifest.json")
            with open(mf) as f:
                doc = json.load(f)
            doc.update(tag="iter3", time=doc["time"] + 1)
            with open(mf, "w") as f:
                json.dump(doc, f)
        collectives.barrier()
        real_open = fsys.open_file

        def failing_open(path, *a, **kw):
            if "iter3" in str(path):
                raise OSError("injected read error")
            return real_open(path, *a, **kw)
        if rank == 1:
            fsys.open_file = failing_open
        try:
            got = load_latest_valid(pick)
        finally:
            fsys.open_file = real_open
        res["picked"] = os.path.basename(got[0])
        res["picked_params"] = got[1]
        res["pick_dirs"] = sorted(os.listdir(pick))
except BaseException as e:
    res["error"] = type(e).__name__
    res["message"] = str(e)[:2000]
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    traceback.print_exc()
    sys.exit(1)
with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(res, f)
print("DONE", rank, flush=True)
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp, scenario, world):
    """Run the rank script as `world` ranks: {rank: results}."""
    out = tmp / scenario
    out.mkdir()
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, REPO_ROOT=REPO, SCENARIO=scenario,
                   OUT_DIR=str(out), CKPT=str(tmp / "ckpt"),
                   INPUTS=str(tmp / "inputs.pkl"),
                   COMMON=str(tmp / "common.py"), STEPS=str(STEPS),
                   LR=str(LR), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), RANK=str(r),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(tmp / "rank.py")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0] * world, \
        "\n".join(logs)[-6000:]
    got = {}
    for r in range(world):
        with open(out / f"rank{r}.pkl", "rb") as f:
            got[r] = pickle.load(f)
    return got


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    (tmp / "rank.py").write_text(_RANK_SCRIPT)
    (tmp / "common.py").write_text(_COMMON)
    jm = tp_net(jnn)
    params = _np(jm.init(jax.random.PRNGKey(5)))
    state = {k: _np(v) for k, v in jm.state_init().items()}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump((params, state), f)
    return tmp, params, state


@pytest.fixture(scope="module")
def tp(setup):
    return _launch(setup[0], "tp", 4)


@pytest.fixture(scope="module")
def resumed(setup, tp):
    return _launch(setup[0], "resume", 4)


@pytest.fixture(scope="module")
def dp(setup, tp):
    return _launch(setup[0], "dp", 2)


def _jax_optimizer(setup, ckpt=None):
    _, params, state = setup
    jm = tp_net(jnn)
    jm.set_params(jax.tree_util.tree_map(jnp.asarray, params))
    jm._state = jax.tree_util.tree_map(jnp.asarray, state)
    x, y = tp_data()
    mesh = jbuild_mesh(data=2, model=2, devices=jax.devices()[:4])
    opt = JDistri(jm, JLocalDataSet([JMiniBatch(x, y)]),
                  jnn.ClassNLLCriterion(), mesh=mesh,
                  sharding_rules=JRules(min_shard_dim=128))
    opt.set_optim_method(joptim.SGD(learning_rate=LR, momentum=0.9))
    opt.set_end_when(joptim.max_iteration(STEPS))
    if ckpt is not None:
        opt.set_checkpoint(ckpt, lambda s: s["neval"] == 2, sharded=True)
    losses = []
    opt.set_iteration_hook(lambda s: losses.append(s["loss"]))
    return jm, opt, losses


@pytest.fixture(scope="module")
def jax_tp(setup, tmp_path_factory):
    """The JAX (2, 2) run, checkpointing sharded (orbax) at step 2, then a
    fresh JAX optimizer resuming from it: (losses, params, state, resumed
    losses, the checkpoint's directory)."""
    ckpt = str(tmp_path_factory.mktemp("jax_tp") / "ckpt")
    jm, opt, losses = _jax_optimizer(setup, ckpt)
    opt.optimize()
    jm2, again, resumed = _jax_optimizer(setup, ckpt)
    assert again.resume_from_latest_checkpoint()
    # the reference's orbax restore gives the BN state's module-path keys
    # back as their strings ("('1_SpatialBatchNormalization',)"), which its
    # own step cannot merge with the tuple keys: put the tuples back
    jm2._state = {ast.literal_eval(k) if isinstance(k, str) else k: v
                  for k, v in jm2._state.items()}
    again.optimize()
    return (losses, _np(jm.ensure_params()),
            {k: _np(v) for k, v in jm._state.items()}, resumed, ckpt)


def _close_tree(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close_tree(got[k], want[k], f"{path}/{k}")
        return
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0,
        atol=RTOL * max(float(np.abs(want).max()), 1e-6), err_msg=path)


def _equal_tree(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _equal_tree(got[k], want[k], f"{path}/{k}")
        return
    np.testing.assert_array_equal(got, want, err_msg=path)


def _max_rel_tree(got, want):
    if isinstance(want, dict):
        return max((_max_rel_tree(got[k], want[k]) for k in want),
                   default=0.0)
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def test_two_by_two_matches_the_jax_mesh(tp, jax_tp):
    j_losses, j_params, j_state = jax_tp[:3]
    for r in range(4):
        got = tp[r]["plain"]
        np.testing.assert_allclose(got["losses"], j_losses, rtol=RTOL)
        _close_tree(got["params"], j_params)
        _close_tree({tuple(k): v for k, v in got["state"].items()},
                    {tuple(k): v for k, v in j_state.items()})


def test_two_by_two_matches_data_parallel_bitwise(tp, dp):
    for r in range(4):
        want = dp[tp[r]["coords"][0]]["plain"]
        assert tp[r]["plain"]["losses"] == want["losses"]
        _equal_tree(tp[r]["plain"]["params"], want["params"])
        _equal_tree(tp[r]["plain"]["state"], want["state"])


def test_clipping_matches_data_parallel(tp, dp):
    for r in range(4):
        want = dp[tp[r]["coords"][0]]["clip"]
        np.testing.assert_allclose(tp[r]["clip"]["losses"], want["losses"],
                                   rtol=CLIP_RTOL)
        assert _max_rel_tree(tp[r]["clip"]["params"],
                             want["params"]) <= CLIP_RTOL
    # clipping bit: the clipped run differs from the plain one
    assert tp[0]["clip"]["losses"][-1] != tp[0]["plain"]["losses"][-1]


def test_lamb_norms_are_the_whole_parameters(tp, dp):
    """LAMB's trust ratio takes the norms of the whole weight: the shards'
    squared norms summed over the model group, one all-reduce a step."""
    for r in range(4):
        want = dp[tp[r]["coords"][0]]["lamb"]
        np.testing.assert_allclose(tp[r]["lamb"]["losses"], want["losses"],
                                   rtol=CLIP_RTOL)
        assert _max_rel_tree(tp[r]["lamb"]["params"],
                             want["params"]) <= CLIP_RTOL
    assert tp[0]["lamb"]["counts"]["norm"] == STEPS
    assert dp[0]["lamb"]["counts"].get("norm", 0) == 0
    assert tp[0]["lamb"]["losses"][-1] != tp[0]["plain"]["losses"][-1]


def test_observed_run_norms_are_the_whole_parameters(tp, dp):
    """Telemetry with the gradient norms and a skipping NaN guard at
    (2, 2): rank 0 alone writes; its records validate; the norms are the
    whole parameters' (those of the (2, 1) run within a relative 1e-6);
    the FLOPs a step count every rank's step; and a guard that never
    fires leaves the run bit for bit the plain one."""
    from bigdl_tpu_torch.observability import validate_record
    want = [r for r in dp[0]["observed"]["records"] if r["type"] == "step"]
    for rank in range(4):
        got = tp[rank]["observed"]
        _equal_tree(got["params"], tp[rank]["plain"]["params"])
        assert got["losses"] == tp[rank]["plain"]["losses"]
        if rank:
            assert got["records"] == []
    recs = tp[0]["observed"]["records"]
    for r in recs:
        validate_record(r)
    assert recs[0]["n_devices"] == 4 and dp[0]["observed"]["records"][0][
        "n_devices"] == 2
    steps = [r for r in recs if r["type"] == "step"]
    assert [r["step"] for r in steps] == list(range(1, STEPS + 1))
    for g, w in zip(steps, want):
        assert g["nonfinite_steps"] == 0
        for key in ("grad_norm", "param_norm"):
            assert g[key] == pytest.approx(w[key], rel=1e-6), key
        # each rank of a model group runs the whole replicated step
        assert g["flops_per_step"] == 2 * w["flops_per_step"] > 0


def test_a_failed_run_gives_back_the_start_of_run_weights(setup, tp):
    _, params, state = setup
    for r in range(4):
        got = tp[r]["failed"]
        assert got["shapes"]["4_Linear.weight"] == (512, 256)
        _equal_tree(got["params"], params)
        _equal_tree({tuple(k): v for k, v in got["state"].items()},
                    {tuple(k): v for k, v in state.items()})


def test_a_dataset_sharded_over_the_world_is_refused(tp):
    for r in range(4):
        msg = tp[r]["refused"]
        assert msg is not None and f"host {r} of 4" in msg
        assert f"data replica {r // 2} of 2" in msg


def test_ranks_agree_on_the_checkpoint_to_load(dp):
    # rank 1 could not read iter3: neither rank loads it, nor is it
    # quarantined (a read error is not proven corruption)
    assert [dp[r]["picked"] for r in range(2)] == ["iter2", "iter2"]
    assert dp[0]["pick_dirs"] == ["iter2", "iter3"]
    _equal_tree(dp[1]["picked_params"], dp[0]["picked_params"])


def test_each_rank_stores_its_shard(tp, dp):
    for r in range(4):
        stored = tp[r]["plain"]["stored"]
        assert tp[r]["coords"] == [r // 2, r % 2]
        assert stored["sharded"] == ["4_Linear.weight"]
        full = dp[0]["plain"]["stored"]
        for name, shape in full["params"].items():
            want = (512, 128) if name == "4_Linear.weight" else shape
            assert stored["params"][name] == want
            assert stored["velocity"][name] == want
    counts = tp[0]["plain"]["counts"]
    # one gather a step, of the whole [512, 256] f32 weight, and one at
    # the end of the run; the gradient buckets carry half of it
    assert counts["gather"] == STEPS and counts["unshard"] == 1
    assert counts["gather_bytes"] == STEPS * 512 * 256 * 4
    n_params = sum(int(np.prod(s))
                   for s in dp[0]["plain"]["stored"]["params"].values())
    assert counts["grad_bytes"] == STEPS * 4 * (n_params - 512 * 128)
    assert counts["bn"] == STEPS * 4 and counts["loss"] == STEPS
    assert dp[0]["plain"]["counts"].get("gather", 0) == 0


def test_a_split_conv_trains_and_checkpoints_in_the_reference_layout(
        setup, tp, dp):
    """`ShardingRules(8)` also splits the conv's 8 output channels: the
    port's OIHW weight on dim 0, the checkpoint's HWIO kernel on dim 3."""
    for r in range(4):
        got = tp[r]["conv"]
        assert got["stored"]["sharded"] == ["0_SpatialConvolution.weight",
                                            "4_Linear.weight"]
        assert got["stored"]["params"]["0_SpatialConvolution.weight"] == \
            (4, 3, 3, 3)
        want = dp[tp[r]["coords"][0]]["plain"]
        assert got["losses"] == want["losses"]
        _equal_tree(got["params"], want["params"])
    params, _, blob = tsc.load_checkpoint_sharded(
        str(setup[0] / "ckpt_conv" / "iter2"))
    whole, _, wblob = jckpt.load_checkpoint(
        str(setup[0] / "ckpt_v2" / "iter2"))
    _equal_tree(params, whole)
    _equal_tree(blob["slots"], wblob["slots"])


def test_dropout_masks_per_model_group_and_data_replica(tp):
    # each step: (the dropout's input != 0, its output != 0), a row each
    m = {r: tp[r]["masks"] for r in range(4)}
    assert m[0].shape == (STEPS, 2, 8, 256)
    np.testing.assert_array_equal(m[0], m[1])
    np.testing.assert_array_equal(m[2], m[3])
    live0, live2 = m[0][:, 0] & m[2][:, 0], m[0][:, 0]
    assert (m[0][:, 1] != m[2][:, 1])[live0 == 1].mean() > 0.2
    assert abs(m[0][:, 1][live2 == 1].mean() - 0.8) < 0.05


def test_sharded_checkpoint_resumes_bitwise_in_a_fresh_launch(tp, resumed):
    for r in range(4):
        for kind, run in (("sharded", "plain"), ("v2", "v2")):
            assert resumed[r][kind]["losses"] == tp[r][run]["losses"][2:]
            _equal_tree(resumed[r][kind]["params"], tp[r][run]["params"])
        # the checkpoints change nothing of the run
        assert tp[r]["v2"]["losses"] == tp[r]["plain"]["losses"]


def test_sharded_checkpoint_restores_on_other_meshes(setup, tp, resumed,
                                                     dp):
    tmp = setup[0]
    ckpt = tmp / "ckpt"
    assert [os.path.basename(p) for p in
            jckpt.valid_checkpoints(str(ckpt))] == ["iter2"]
    assert sorted(os.listdir(ckpt / "iter2")) == [
        "arrays", "manifest.json", "optim.json"]
    # the v2 checkpoint at step 2 holds the whole parameters: the
    # reference (a plain numpy tree) and the (2, 1) run agree on them
    whole, _, blob = jckpt.load_checkpoint(str(tmp / "ckpt_v2" / "iter2"))
    assert blob["state"]["neval"] == 2
    # (2, 1): resumed from the (2, 2) sharded checkpoint, bitwise
    for r in range(2):
        assert dp[r]["resumed"]["losses"] == dp[r]["plain"]["losses"][2:]
        _equal_tree(dp[r]["resumed"]["params"], dp[r]["plain"]["params"])
        _equal_tree(dp[r]["restored"], whole)
        assert set(dp[r]["restored_kind"].values()) == {"Tensor"}
    # (2, 2): each rank reads its own shard of the split weight
    for r in range(4):
        kinds = resumed[r]["restored_kind"]
        assert kinds.pop("4_Linear/weight") == "DTensor"
        assert set(kinds.values()) == {"Tensor"}
        got = resumed[r]["restored"]
        c = r % 2
        np.testing.assert_array_equal(
            got["4_Linear"]["weight"],
            whole["4_Linear"]["weight"][:, 128 * c:128 * (c + 1)])
        got["4_Linear"]["weight"] = whole["4_Linear"]["weight"]
        _equal_tree(got, whole)
    # one process, no group: the whole arrays, as saved
    params, mstate, oblob = tsc.load_checkpoint_sharded(str(ckpt / "iter2"))
    _equal_tree(params, whole)
    assert oblob["state"]["neval"] == 2
    assert set(oblob["slots"]) == {"velocity"}
    assert set(mstate) == {("1_SpatialBatchNormalization",)}
    got = tsc.restore_sharded(str(ckpt / "iter2" / "arrays"),
                              {"params": whole})
    _equal_tree({k: {n: t.numpy() for n, t in v.items()}
                 for k, v in got["params"].items()}, whole)


def test_v2_checkpoint_under_tp_loads_in_the_reference(setup, tp):
    params, state, blob = jckpt.load_checkpoint(
        str(setup[0] / "ckpt_v2" / "iter2"))
    jm = tp_net(jnn)
    assert jax.tree_util.tree_structure(jm.ensure_params()) == \
        jax.tree_util.tree_structure(params)
    assert params["4_Linear"]["weight"].shape == (512, 256)
    assert blob["slots"]["velocity"]["4_Linear"]["weight"].shape == \
        (512, 256)
    assert set(state) == {("1_SpatialBatchNormalization",)}


def test_sharded_resume_matches_the_reference(setup, resumed, jax_tp):
    j_resumed, ckpt = jax_tp[3], jax_tp[4]
    for r in range(4):
        np.testing.assert_allclose(resumed[r]["sharded"]["losses"],
                                   j_resumed, rtol=RTOL)
    # the documents carry the reference's keys
    for doc in ("optim.json", "manifest.json"):
        with open(os.path.join(ckpt, "iter2", doc)) as f:
            want = json.load(f)
        with open(setup[0] / "ckpt" / "iter2" / doc) as f:
            got = json.load(f)
        assert set(got) == set(want), doc
        if doc == "optim.json":
            assert set(got["state"]) == set(want["state"])
            assert got["class"] == want["class"] == "SGD"
        else:
            assert got["sharded"] is want["sharded"] is True
            assert got["format"] == want["format"]
