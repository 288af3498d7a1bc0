"""Port parity: synchronous data parallel over `torch.distributed` (gloo on
the CPU, one process a rank) against the JAX `DistriOptimizer` on a
2-device mesh.

Mirrors `tests/test_multihost.py`: a rank script (`_RANK_SCRIPT`) runs in
real processes, two ranks joined by `Engine.init(distributed=True)` from
the launcher's environment, and writes its results for the tests to
read. Three launches serve the whole file (module-scoped fixtures):
- `runs`: every scenario of one healthy 2-rank run, and the NaN guard's
  skip with rank 1's third batch poisoned (its flag agreed over the ranks
  with one all-reduce, so both ranks revert; rank 0 alone writes the
  telemetry records);
- `resumed`: a fresh 2-rank launch resuming from `runs`' checkpoint;
- `one_rank_fault`: a transient fault on rank 1 alone;
- `widedeep`: Wide&Deep (`BASELINE.md` config 5) at global b16, each
  rank's 8 rows of all four input tensors, the model taking their 1-based
  `Table`.
Each rank pins torch to one thread; each launch has a 120 s limit.

The model is conv (no bias: BN takes out its gradient) -> BN -> ReLU (a
fused kernel 6/7 site) -> max pool -> `Reshape` -> `Linear` ->
`LogSoftMax` under `ClassNLLCriterion`, in f32,
with the JAX model's weights carried into the port. Each rank's shard is
one `MiniBatch` of 4 rows of a seeded numpy batch of 8; the JAX side
trains on the whole batch of 8 over `build_mesh(data=2)`.

Tolerances: losses within a relative 1e-5, and each parameter tensor and
BN running stat within 1e-5 of its largest element (the same f32 math
summed in other orders: the global BN sums are two partial sums, the
gradients two halves). Against the port's own one-process run on the
whole batch, the same. Bucket sizes, resume and lockstep retry are held
bitwise: they change no arithmetic (a sum of two ranks' terms is the
same in any grouping).
"""

import json
import os
import pickle
import socket
import subprocess
import sys
import time

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
from bigdl_tpu.optim.bucketing import GradientBucketPlan as JPlan
from bigdl_tpu.serialization import checkpoint as jckpt
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import (DataSet, DistributedDataSet,
                                     LocalDataSet, MiniBatch)
from bigdl_tpu_torch.interop import load_module_params, module_params_tree
from bigdl_tpu_torch.optim.bucketing import GradientBucketPlan
from bigdl_tpu_torch.parallel import collectives
from bigdl_tpu_torch.resilience import RetryPolicy
from bigdl_tpu_torch.utils import engine as tengine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
STEPS = 5

# The models and data, shared verbatim by the ranks (exec'd) and the
# tests: one copy of the code both sides build from.
_COMMON = r'''
import numpy as np

def conv_net(nn, **kw):
    return (nn.Sequential()
            .add(nn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1,
                                       with_bias=False, **kw))
            .add(nn.SpatialBatchNormalization(4, **kw))
            .add(nn.ReLU())
            .add(nn.SpatialMaxPooling(2, 2, 2, 2))
            .add(nn.Reshape((64,)))
            .add(nn.Linear(64, 5, **kw))
            .add(nn.LogSoftMax()))

def mask_net(nn, **kw):
    return nn.Sequential().add(nn.Linear(6, 5, **kw)).add(nn.LogSoftMax())

def dropout_net(nn, **kw):
    return (nn.Sequential().add(nn.Linear(8, 32, **kw)).add(nn.Dropout(0.5))
            .add(nn.Linear(32, 3, **kw)).add(nn.LogSoftMax()))

def conv_data():
    rs = np.random.RandomState(11)
    x = rs.rand(8, 8, 8, 3).astype(np.float32)
    y = (rs.randint(0, 5, size=8) + 1).astype(np.int32)
    return x, y

def mask_data():
    rs = np.random.RandomState(12)
    x = rs.randn(8, 6).astype(np.float32)
    # rank 0 keeps 3 positions of its 4, rank 1 one
    y = np.array([1, 0, 3, 2, 0, 0, 4, 0], np.int32)
    return x, y

def widedeep_net(nn, **kw):
    """Config 5's WideAndDeep from the package `nn` belongs to."""
    import importlib
    models = importlib.import_module(nn.__name__[:-len("nn")] + "models")
    return models.WideAndDeep(2, wide_dim=100, embed_vocabs=(10, 10),
                              embed_dim=4, cont_dim=3, **kw)

def widedeep_data():
    rs = np.random.RandomState(14)
    x = [rs.randint(0, 100, (16, 3)).astype(np.int32),
         rs.rand(16, 3).astype(np.float32),
         rs.randint(1, 10, (16, 2)).astype(np.int32),
         rs.rand(16, 3).astype(np.float32)]
    y = (rs.randint(0, 2, 16) + 1).astype(np.int32)
    return x, y

def dropout_data():
    rs = np.random.RandomState(13)
    x = rs.randn(8, 8).astype(np.float32)
    y = (rs.randint(0, 3, size=8) + 1).astype(np.int32)
    return x, y
'''
exec(_COMMON)

_RANK_SCRIPT = r'''
import json, os, pickle, sys, time, traceback
sys.path.insert(0, os.environ["REPO_ROOT"])
import numpy as np
import torch
torch.set_num_threads(1)

from bigdl_tpu_torch.utils.engine import Engine
Engine.init(distributed=True, timeout_s=float(os.environ["TIMEOUT_S"]))

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch import optim
from bigdl_tpu_torch.dataset import (DistributedDataSet, LocalDataSet,
                                     MiniBatch, Sample)
from bigdl_tpu_torch.interop import (load_module_params, module_params_tree,
                                     module_state)
from bigdl_tpu_torch.parallel import collectives
from bigdl_tpu_torch.resilience import FaultInjector, FaultSpec

exec(open(os.environ["COMMON"]).read())
STEPS = int(os.environ["STEPS"])
rank, world = collectives.rank(), Engine.node_number()
out_dir = os.environ["OUT_DIR"]
with open(os.environ["INPUTS"], "rb") as f:
    inputs = pickle.load(f)
rows = slice(4 * rank, 4 * rank + 4)


def copy_tree(t):
    if isinstance(t, dict):
        return {k: copy_tree(v) for k, v in t.items()}
    return np.array(t, copy=True)


def model_of(builder, key):
    m = builder(nn, device="cpu")
    load_module_params(m, *inputs[key])
    return m


def train(model, batch, steps, crit=None, accum=1, clip=None,
          bucket_mb=None, ckpt=None, resume=False, lr=0.1, every=None):
    """`steps` SGD steps over this rank's resident `batch`: the synced
    losses, the final parameters and BN state (numpy), the optimizer."""
    opt = optim.DistriOptimizer(model, LocalDataSet([MiniBatch(*batch)]),
                                crit or nn.ClassNLLCriterion(),
                                devices=["cpu"], retry_interval_s=0.0)
    opt.set_optim_method(optim.SGD(learning_rate=lr, momentum=0.9))
    opt.set_end_when(optim.max_iteration(steps))
    if accum > 1:
        opt.set_gradient_accumulation(accum)
    if clip is not None:
        opt.set_gradient_clipping_by_l2_norm(clip)
    if bucket_mb is not None:
        opt.set_gradient_bucketing(bucket_mb)
    if ckpt is not None:
        opt.set_checkpoint(ckpt, every or (lambda s: s["neval"] == 3))
    if resume:
        assert opt.resume_from_latest_checkpoint()
    losses, at3 = [], {}

    def hook(s):
        losses.append(s["loss"])
        if s["neval"] == 3:
            at3["params"] = copy_tree(module_params_tree(model))
    opt.set_iteration_hook(hook)
    opt.optimize()
    return {"losses": losses, "params": copy_tree(module_params_tree(model)),
            "state": copy_tree(module_state(model)), "at3": at3}, opt


def conv_batch():
    x, y = conv_data()
    return x[rows], y[rows]


class Ordered:
    """These batches in order, looping, each pull a fresh copy."""

    def __init__(self, batches):
        self.batches = batches

    def data(self, train):
        def looped():
            while True:
                for x, y in self.batches:
                    yield MiniBatch(x.copy(), y.copy())
        return looped()

    def size(self):
        return sum(len(x) for x, _ in self.batches)

    def shuffle(self):
        pass


def guarded(key, check_grads, poisoned):
    """Under NanGuard("skip"): [clean, clean, rank 1's batch NaN] when
    `poisoned`, else [clean, clean]; this rank's telemetry records and its
    final parameters and BN state."""
    from bigdl_tpu_torch.observability import (InMemorySink, NanGuard,
                                               Telemetry)
    if key == "conv":
        xb, yb = conv_batch()
    else:
        xb = mask_data()[0][rows]
        yb = (np.arange(4, dtype=np.int32) + rank) % 5 + 1
    bad = xb.copy()
    if rank == 1:
        bad[:] = np.nan
    batches = [(xb, yb), (xb, yb)] + ([(bad, yb)] if poisoned else [])
    model = model_of(conv_net if key == "conv" else mask_net, key)
    opt = optim.DistriOptimizer(model, Ordered(batches),
                                nn.ClassNLLCriterion(), devices=["cpu"])
    opt.set_optim_method(optim.SGD(learning_rate=0.1, momentum=0.9))
    opt.set_end_when(optim.max_iteration(len(batches)))
    sink = InMemorySink()
    opt.set_telemetry(Telemetry(sink, grad_norms=True, resources=False,
                                flight=False))
    opt.set_health_monitors(NanGuard("skip", check_grads=check_grads))
    collectives.reset_counts()
    opt.optimize()
    return {"records": sink.records, "counts": dict(collectives.counts),
            "params": copy_tree(module_params_tree(model)),
            "state": copy_tree(module_state(model))}


res = {"rank": rank, "world": world}
scenario = os.environ["SCENARIO"]
try:
    if scenario == "runs":
        collectives.reset_counts()
        res["plain"], opt = train(model_of(conv_net, "conv"), conv_batch(),
                                  5)
        res["plain"]["counts"] = dict(collectives.counts)
        res["plain"]["n_buckets"] = len(opt.bucket_plan)
        res["accum_clip"], _ = train(model_of(conv_net, "conv"),
                                     conv_batch(), 5, accum=2, clip=0.05)
        res["buckets"] = {}
        for name, mb in (("several", 2e-4), ("one", 64.0),
                         ("default", None)):
            r, opt = train(model_of(conv_net, "conv"), conv_batch(), 3,
                           bucket_mb=mb)
            r["n_buckets"] = len(opt.bucket_plan)
            res["buckets"][name] = r
        x, y = mask_data()
        res["mask"], _ = train(
            model_of(mask_net, "mask"), (x[rows], y[rows]), 3,
            crit=nn.TimeDistributedMaskCriterion(nn.ClassNLLCriterion()),
            lr=0.5)
        res["ckpt"], _ = train(model_of(conv_net, "conv"), conv_batch(), 6,
                               ckpt=os.environ["CKPT"])
        # the global dataset: 16 samples, 8 a rank, batches of 2
        xs, ys = conv_data()
        samples = [Sample(xs[i % 8], ys[i % 8]) for i in range(16)]
        shard = DistributedDataSet(samples)
        res["dataset"] = {"size": shard.size(),
                          "global_size": shard.global_size,
                          "host_index": shard.host_index,
                          "num_hosts": shard.num_hosts,
                          "items": [i for i in range(16)
                                    if any(s is samples[i]
                                           for s in shard.items)]}
        o = optim.Optimizer(model_of(conv_net, "conv"), shard,
                            nn.ClassNLLCriterion(), batch_size=2,
                            device="cpu")
        o.set_end_when(optim.max_iteration(6))
        marks = []
        o.set_iteration_hook(lambda s: marks.append(
            (s["neval"], s["epoch"], s["recordsProcessedThisEpoch"])))
        o.optimize()
        res["dataset"].update(kind=type(o).__name__,
                              transformed_global_size=o.dataset.global_size,
                              marks=marks)
        # dropout, and a lockstep fault at step 4 on both ranks
        masks = {"clean": [], "faulted": []}
        for run in ("clean", "faulted"):
            m = model_of(dropout_net, "dropout")
            drop = m.children_in_order()[1]
            drop.register_forward_hook(
                lambda mod, i, o, run=run: masks[run].append(
                    (o != 0).numpy().astype(np.uint8)))
            xd, yd = dropout_data()
            kw = dict(ckpt=os.environ["CKPT"] + "_" + run,
                      every=optim.several_iteration(2))
            if run == "faulted":
                with FaultInjector(FaultSpec("train.step", at_hit=4)):
                    res[run], _ = train(m, (xd[rows], yd[rows]), 6, **kw)
            else:
                res[run], _ = train(m, (xd[rows], yd[rows]), 6, **kw)
        res["masks"] = masks
        res["guard"] = {name: guarded(*args) for name, args in (
            ("linear", ("mask", False, True)),
            ("linear_clean", ("mask", False, False)),
            ("conv", ("conv", True, True)),
            ("conv_clean", ("conv", True, False)))}
        # preemption: SIGTERM reaches rank 1 alone at step 3 of 6; the
        # ranks agree on the latch, stop together, rank 0 writes the
        # checkpoint; then both resume from it to step 6
        import signal
        from bigdl_tpu_torch.observability import InMemorySink, Telemetry
        pdir = os.environ["CKPT"] + "_preempt"
        popt = optim.DistriOptimizer(
            model_of(conv_net, "conv"), LocalDataSet([MiniBatch(
                *conv_batch())]), nn.ClassNLLCriterion(), devices=["cpu"],
            retry_interval_s=0.0)
        popt.set_optim_method(optim.SGD(learning_rate=0.1, momentum=0.9))
        popt.set_end_when(optim.max_iteration(6))
        popt.set_checkpoint(pdir, optim.several_iteration(1000))
        popt.set_preemption_handler(grace_s=30.0)
        psink = InMemorySink()
        popt.set_telemetry(Telemetry(psink, resources=False, flight=False))
        popt.set_iteration_hook(
            lambda s: signal.raise_signal(signal.SIGTERM)
            if rank == 1 and s["neval"] == 3 else None)
        collectives.reset_counts()
        popt.optimize()
        res["preempt_run"] = {
            "neval": popt.optim_method.state["neval"],
            "records": [r.get("event", r["type"]) for r in psink.records],
            "preempted": [r for r in psink.records
                          if r.get("event") == "preempted"],
            "allreduces": collectives.counts["preempt"],
            "restored": signal.getsignal(signal.SIGTERM) == signal.SIG_DFL}
        res["preempt_resumed"], _ = train(model_of(conv_net, "conv"),
                                          conv_batch(), 6, ckpt=pdir,
                                          resume=True)
    elif scenario == "widedeep":
        x, y = widedeep_data()
        wrows = slice(8 * rank, 8 * rank + 8)
        collectives.reset_counts()
        res["widedeep"], opt = train(
            model_of(widedeep_net, "widedeep"),
            ([v[wrows] for v in x], y[wrows]), STEPS, lr=0.05)
        res["widedeep"]["counts"] = dict(collectives.counts)
    elif scenario == "resume":
        res["resumed"], _ = train(model_of(conv_net, "conv"), conv_batch(),
                                  6, ckpt=os.environ["CKPT"], resume=True)
    elif scenario == "one_rank_fault":
        plan = FaultInjector(FaultSpec("train.step", at_hit=3))
        if rank == 1:
            plan.install()
        res["t0"] = time.time()
        train(model_of(conv_net, "conv"), conv_batch(), 6,
              ckpt=os.environ["CKPT"])
except BaseException as e:
    res["error"] = type(e).__name__
    res["message"] = str(e)[:500]
    res["t_end"] = time.time()
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


def _launch(tmp, scenario, ckpt, timeout_s=20.0):
    """Run the rank script as 2 ranks; ({rank: results}, exit codes, seconds,
    logs)."""
    out = tmp / scenario
    out.mkdir()
    port = _free_port()
    procs = []
    t0 = time.time()
    for r in range(2):
        env = dict(os.environ, REPO_ROOT=REPO, SCENARIO=scenario,
                   OUT_DIR=str(out), CKPT=str(ckpt),
                   INPUTS=str(tmp / "inputs.pkl"),
                   COMMON=str(tmp / "common.py"), TIMEOUT_S=str(timeout_s),
                   STEPS=str(STEPS),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(tmp / "rank.py")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, rcs = [], []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
            rcs.append(p.returncode)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    seconds = time.time() - t0
    got = {}
    for r in range(2):
        path = out / f"rank{r}.pkl"
        if path.exists():
            with open(path, "rb") as f:
                got[r] = pickle.load(f)
    return got, rcs, seconds, logs


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def _jax_carry(builder, seed):
    """A JAX model, initialised from `seed`, with its params and state."""
    jm = builder(jnn)
    params = _np(jm.init(jax.random.PRNGKey(seed)))
    state = {k: _np(v) for k, v in (jm.state_init() or {}).items()}
    return jm, params, state


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    (tmp / "rank.py").write_text(_RANK_SCRIPT)
    (tmp / "common.py").write_text(_COMMON)
    carried = {}
    for key, builder, seed in (("conv", conv_net, 1), ("mask", mask_net, 2),
                               ("dropout", dropout_net, 3),
                               ("widedeep", widedeep_net, 4)):
        _, params, state = _jax_carry(builder, seed)
        carried[key] = (params, state or None)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(carried, f)
    return tmp, carried


@pytest.fixture(scope="module")
def runs(setup):
    tmp, _ = setup
    got, rcs, _, logs = _launch(tmp, "runs", tmp / "ckpt")
    assert rcs == [0, 0], "\n".join(logs)[-4000:]
    return got


@pytest.fixture(scope="module")
def resumed(setup, runs):
    tmp, _ = setup
    got, rcs, _, logs = _launch(tmp, "resume", tmp / "ckpt")
    assert rcs == [0, 0], "\n".join(logs)[-4000:]
    return got


def _jax_run(builder, key, carried, x, y, steps, crit, accum=1, clip=None,
             lr=0.1):
    """The JAX DistriOptimizer over a 2-device mesh on the whole batch:
    (losses, params, state)."""
    jm = builder(jnn)
    params, state = carried[key]
    jm.set_params(jax.tree_util.tree_map(jnp.asarray, params))
    if state:
        jm._state = jax.tree_util.tree_map(jnp.asarray, state)
    mesh = jbuild_mesh(data=2, devices=jax.devices()[:2])
    opt = JDistri(jm, JLocalDataSet([JMiniBatch(x, y)]), crit, mesh=mesh)
    opt.set_optim_method(joptim.SGD(learning_rate=lr, momentum=0.9))
    opt.set_end_when(joptim.max_iteration(steps))
    if accum > 1:
        opt.set_gradient_accumulation(accum)
    if clip is not None:
        opt.set_gradient_clipping_by_l2_norm(clip)
    losses = []
    opt.set_iteration_hook(lambda s: losses.append(s["loss"]))
    opt.optimize()
    return (losses, _np(jm.ensure_params()),
            {k: _np(v) for k, v in (jm._state or {}).items()})


def _micro_major(a, accum=2, world=2):
    """The global batch ordered so that the reference's micro-batch i (the
    i-th slice of the global batch) is the union over the ranks of each
    shard's i-th slice, which is the port's micro-batch i."""
    shards = a.reshape(world, accum, -1, *a.shape[1:])
    return shards.transpose(1, 0, *range(2, shards.ndim)).reshape(a.shape)


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


def _state_of(state):
    """{module path: {"mean", "var"}} with the paths as tuples."""
    return {tuple(k): v for k, v in state.items()}


@pytest.fixture(scope="module")
def jax_conv(setup):
    _, carried = setup
    x, y = conv_data()
    return _jax_run(conv_net, "conv", carried, x, y, STEPS,
                    jnn.ClassNLLCriterion())


def test_two_ranks_match_the_jax_mesh(runs, jax_conv):
    j_losses, j_params, j_state = jax_conv
    for r in (0, 1):
        got = runs[r]["plain"]
        np.testing.assert_allclose(got["losses"], j_losses, rtol=RTOL)
        _close_tree(got["params"], j_params)
        _close_tree(_state_of(got["state"]), _state_of(j_state))
    # the ranks hold the same model, bit for bit
    _equal_tree(runs[0]["plain"]["params"], runs[1]["plain"]["params"])


def test_two_ranks_match_one_process_on_the_whole_batch(setup, runs):
    _, carried = setup
    model = conv_net(tnn, device="cpu")
    load_module_params(model, *carried["conv"])
    x, y = conv_data()
    opt = toptim.DistriOptimizer(model, LocalDataSet([MiniBatch(x, y)]),
                                 tnn.ClassNLLCriterion(), devices=["cpu"])
    opt.set_optim_method(toptim.SGD(learning_rate=0.1, momentum=0.9))
    opt.set_end_when(toptim.max_iteration(STEPS))
    losses = []
    opt.set_iteration_hook(lambda s: losses.append(s["loss"]))
    opt.optimize()
    np.testing.assert_allclose(runs[0]["plain"]["losses"], losses, rtol=RTOL)
    _close_tree(runs[0]["plain"]["params"], module_params_tree(model))


def test_accumulation_and_clipping_match_the_jax_mesh(setup, runs):
    _, carried = setup
    x, y = conv_data()
    j_losses, j_params, j_state = _jax_run(
        conv_net, "conv", carried, _micro_major(x), _micro_major(y), STEPS,
        jnn.ClassNLLCriterion(), accum=2, clip=0.05)
    got = runs[0]["accum_clip"]
    np.testing.assert_allclose(got["losses"], j_losses, rtol=RTOL)
    _close_tree(got["params"], j_params)
    _close_tree(_state_of(got["state"]), _state_of(j_state))


def test_sigterm_on_one_rank_stops_both_and_resumes_bitwise(runs):
    """SIGTERM on rank 1 alone at step 3 of 6: one "preempt" all-reduce
    an iteration boundary while the handler is armed (none in a run
    without one), both ranks stop at step 3 with the disposition put back,
    rank 0 records `preempted` and `run_abort` (no `run_end`), and the
    run resumed from rank 0's checkpoint ends with the uninterrupted
    6-step run's losses and parameters, bit for bit, on both ranks."""
    for r in (0, 1):
        got = runs[r]["preempt_run"]
        assert got["neval"] == 3 and got["restored"]
        assert got["allreduces"] == 3
        assert "preempt" not in runs[r]["plain"]["counts"]
        whole = runs[r]["ckpt"]
        resumed = runs[r]["preempt_resumed"]
        assert resumed["losses"] == whole["losses"][3:]
        _equal_tree(resumed["params"], whole["params"])
        _equal_tree(_state_of(resumed["state"]), _state_of(whole["state"]))
    records = runs[0]["preempt_run"]["records"]
    assert records[-2:] == ["preempted", "run_abort"]
    assert "run_end" not in records
    pre = runs[0]["preempt_run"]["preempted"][0]
    assert pre["checkpointed"] is True and pre["step"] == 3
    assert pre["signal"] is None  # the signal reached rank 1 only
    assert runs[1]["preempt_run"]["records"] == []


def test_collectives_a_step(runs):
    counts = runs[0]["plain"]["counts"]
    n_buckets = runs[0]["plain"]["n_buckets"]
    # one all-reduce a bucket a step; the BN: 2 forward, 2 backward
    assert counts["grad"] == STEPS * n_buckets
    assert counts["grad_bytes"] == STEPS * 4 * sum(
        int(np.prod(p.shape)) for p in conv_net(tnn, device="cpu")
        .parameters())
    assert counts["bn"] == STEPS * 4
    assert counts["loss"] == STEPS
    assert counts["broadcast"] > 0


def test_bucket_sizes_are_bit_identical(runs):
    b = runs[0]["buckets"]
    assert b["several"]["n_buckets"] > 1
    assert b["one"]["n_buckets"] == b["default"]["n_buckets"] == 1
    for name in ("several", "one"):
        assert b[name]["losses"] == b["default"]["losses"]
        _equal_tree(b[name]["params"], b["default"]["params"])


def test_masked_criterion_takes_the_global_denominator(setup, runs):
    _, carried = setup
    x, y = mask_data()
    crit = jnn.TimeDistributedMaskCriterion(jnn.ClassNLLCriterion())
    j_losses, j_params, _ = _jax_run(mask_net, "mask", carried, x, y, 3,
                                     crit, lr=0.5)
    for r in (0, 1):
        np.testing.assert_allclose(runs[r]["mask"]["losses"], j_losses,
                                   rtol=RTOL)
        _close_tree(runs[r]["mask"]["params"], j_params)


def test_distributed_dataset_shards_and_counts(runs):
    for r in (0, 1):
        d = runs[r]["dataset"]
        assert d["items"] == list(range(r, 16, 2))
        assert (d["size"], d["global_size"], d["host_index"],
                d["num_hosts"]) == (8, 16, r, 2)
        assert d["kind"] == "DistriOptimizer"
        assert d["transformed_global_size"] == 16
        # 2 ranks x 2 records a step; the epoch is the 16 global records
        assert d["marks"] == [(1, 0, 4), (2, 0, 8), (3, 0, 12), (4, 1, 0),
                              (5, 1, 4), (6, 1, 8)]


def test_checkpoint_resumes_bit_identical_in_a_fresh_launch(runs, resumed):
    for r in (0, 1):
        assert resumed[r]["resumed"]["losses"] == \
            runs[r]["ckpt"]["losses"][3:]
        _equal_tree(resumed[r]["resumed"]["params"],
                    runs[r]["ckpt"]["params"])


def test_rank0_checkpoint_loads_in_the_reference(setup, runs):
    tmp, _ = setup
    assert [os.path.basename(p) for p in
            jckpt.valid_checkpoints(str(tmp / "ckpt"))] == ["iter3"]
    params, state, blob = jckpt.load_checkpoint(str(tmp / "ckpt" / "iter3"))
    assert blob["state"]["neval"] == 3
    _equal_tree(params, runs[0]["ckpt"]["at3"]["params"])
    jm = conv_net(jnn)
    assert jax.tree_util.tree_structure(jm.ensure_params()) == \
        jax.tree_util.tree_structure(params)


def test_lockstep_retry_is_bit_identical_and_keeps_the_masks(runs):
    # the faulted run ran steps 1-3, failed before step 4, reloaded the
    # step-2 checkpoint and ran steps 3-6: those are the clean run's
    for r in (0, 1):
        clean, faulted = runs[r]["clean"], runs[r]["faulted"]
        assert faulted["losses"][:3] == clean["losses"][:3]
        assert faulted["losses"][3:] == clean["losses"][2:]
        _equal_tree(faulted["params"], clean["params"])
    masks = runs[0]["masks"]
    assert len(masks["clean"]) == 6 and len(masks["faulted"]) == 7
    for a, b in zip(masks["faulted"][-4:], masks["clean"][-4:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["linear", "conv"])
def test_the_skip_is_agreed_over_the_ranks(runs, name):
    """Rank 1's third batch is NaN. Without the gradient check (the
    linear model) rank 0's own loss stays finite, so only the agreed flag
    makes it skip; the conv model's BN takes NaN statistics over the
    global batch on both. Either way both ranks end on the clean run's
    parameters and BN state, bit for bit, each with one "guard"
    all-reduce a step; rank 0 alone writes the records."""
    from bigdl_tpu_torch.observability import validate_record
    for r in (0, 1):
        got, clean = runs[r]["guard"][name], runs[r]["guard"][name + "_clean"]
        _equal_tree(got["params"], clean["params"])
        _equal_tree(got["state"], clean["state"])
        assert got["counts"]["guard"] == 3
    _equal_tree(runs[0]["guard"][name]["params"],
                runs[1]["guard"][name]["params"])
    assert runs[1]["guard"][name]["records"] == []
    recs = runs[0]["guard"][name]["records"]
    for rec in recs:
        validate_record(rec)
    assert [r.get("event", r["type"]) for r in recs] == \
        ["run_start", "compile", "step", "step", "nan_guard", "step",
         "run_end"]
    steps = [r for r in recs if r["type"] == "step"]
    # the compile record counts the global step: both ranks' batches
    assert recs[1]["flops"] == steps[0]["flops_per_step"]
    assert [r["nonfinite_steps"] for r in steps] == [0, 0, 1]
    assert recs[0]["loop"] == "distri" and recs[0]["n_devices"] == 2
    assert np.isnan(steps[2]["loss"])


def test_dropout_masks_differ_across_ranks(runs):
    m0 = np.stack(runs[0]["masks"]["clean"])
    m1 = np.stack(runs[1]["masks"]["clean"])
    assert m0.shape == m1.shape == (6, 4, 32)
    assert (m0 != m1).mean() > 0.3
    for m in (m0, m1):
        assert abs(m.mean() - 0.5) < 0.06
        # each step draws new masks
        assert all((m[i] != m[i + 1]).any() for i in range(5))


def test_widedeep_two_ranks_match_the_jax_mesh(setup):
    """Config 5 at global b16 over two gloo ranks, each given its rows of
    the four input tensors, against the JAX DistriOptimizer on the whole
    batch over a 2-device mesh: the tolerances above, and one gradient
    all-reduce a step (one bucket)."""
    tmp, carried = setup
    got, rcs, _, logs = _launch(tmp, "widedeep", tmp / "ckpt_wd")
    assert rcs == [0, 0], "\n".join(logs)[-4000:]
    x, y = widedeep_data()
    j_losses, j_params, _ = _jax_run(widedeep_net, "widedeep", carried, x,
                                     y, STEPS, jnn.ClassNLLCriterion(),
                                     lr=0.05)
    for r in (0, 1):
        run = got[r]["widedeep"]
        np.testing.assert_allclose(run["losses"], j_losses, rtol=RTOL)
        _close_tree(run["params"], j_params)
        assert run["counts"]["grad"] == STEPS
    _equal_tree(got[0]["widedeep"]["params"], got[1]["widedeep"]["params"])


def test_a_fault_on_one_rank_stops_both(setup):
    tmp, _ = setup
    got, rcs, seconds, logs = _launch(tmp, "one_rank_fault",
                                      tmp / "ckpt_fault", timeout_s=5.0)
    assert rcs[0] != 0 and rcs[1] != 0, "\n".join(logs)[-4000:]
    assert seconds < 60
    assert got[1]["error"] == "TransientInjectedFault"
    assert got[0]["error"] == "CollectiveError"


# ------------------------------------------------ in one process, no launch

_LEAVES = [(3, 4), (4,), (16, 16), (2, 2, 3), (64,), (5,), (40, 8)]


@pytest.mark.parametrize("bucket_bytes", [1, 100, 512, 1100, 4 * 2 ** 20])
def test_bucket_plan_matches_the_reference(bucket_bytes):
    arrays = [np.zeros(s, np.float32) for s in _LEAVES]
    want = JPlan(arrays, bucket_bytes)
    got = GradientBucketPlan([torch.zeros(s) for s in _LEAVES],
                             bucket_bytes)
    assert got.buckets == want.buckets
    assert got.layouts == [tuple((sh, "torch.float32") for sh, _ in lay)
                           for lay in want.layouts]
    assert got.describe() == want.describe()


def test_bucket_plan_splits_and_joins_a_tree():
    tree = {"a": torch.zeros(3), "b": [torch.ones(2, 2), torch.zeros(5)],
            "c": {"d": torch.full((4,), 2.0)}}
    plan = GradientBucketPlan(tree, bucket_bytes=20)
    assert plan.buckets == [(3,), (2,), (1,), (0,)]
    parts = plan.split(tree)
    assert [len(p) for p in parts] == [1, 1, 1, 1]
    back = plan.join(parts)
    assert back["c"]["d"] is tree["c"]["d"] and back["b"][0] is tree["b"][0]
    assert isinstance(back["b"], list)
    with pytest.raises(ValueError, match="leaves"):
        plan.split([torch.zeros(1)])
    # a dtype change ends a bucket (the port concatenates each bucket)
    mixed = GradientBucketPlan([torch.zeros(2), torch.zeros(2).bfloat16()])
    assert mixed.buckets == [(1,), (0,)]


def test_bucketed_mean_is_the_identity_alone():
    grads = [torch.arange(6.0).reshape(2, 3), torch.ones(4)]
    out = collectives.bucket_all_reduce_mean(grads, [(1, 0)], world=1)
    assert all(torch.equal(a, b) for a, b in zip(out, grads))
    assert collectives.counts["grad"] == 0


def test_engine_config_env_and_validation(monkeypatch):
    eng = tengine._Engine()
    monkeypatch.setenv("BIGDL_TPU_IO_THREADS", "7")
    monkeypatch.setenv("BIGDL_TPU_TIMEOUT_S", "30")
    eng.init()
    assert eng.config["io_threads"] == 7
    assert eng.config["timeout_s"] == 30.0
    with pytest.raises(KeyError, match="unknown Engine config key"):
        eng.init(no_such_key=1)
    with pytest.raises(ValueError, match="io_threads"):
        eng.init(io_threads=0)
    with pytest.raises(ValueError, match="timeout_s"):
        eng.init(timeout_s=0)
    assert eng.config["io_threads"] == 7  # a refused init changes nothing
    assert (eng.node_number(), eng.total_devices()) == (1, 1)
    assert eng.core_number() >= 1


def test_engine_distributed_needs_the_launcher_env(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        tengine._Engine().init(distributed=True)


def test_dataset_array_and_shards_alone():
    assert type(DataSet.array(list(range(5)))) is LocalDataSet
    ds = DataSet.array(list(range(5)), 1, 2)
    assert isinstance(ds, DistributedDataSet)
    assert (ds.items, ds.size(), ds.global_size) == ([1, 3], 2, 5)
    alone = DistributedDataSet(list(range(5)))
    assert (alone.host_index, alone.num_hosts, alone.size()) == (0, 1, 5)
    with pytest.raises(ValueError, match="host_index"):
        DistributedDataSet([1, 2], 2, 2)


def test_collective_failures_are_permanent():
    policy = RetryPolicy()
    assert not policy.is_transient(collectives.CollectiveError("peer gone"))
    assert not policy.is_transient(torch.distributed.DistError("timeout"))
    assert policy.is_transient(OSError("disk"))


def test_no_step_no_global_statistics():
    """Outside a data-parallel step (and at world size 1) the BN layer and
    the masked criterion issue nothing and compute what they did."""
    bn = tnn.SpatialBatchNormalization(3, device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 4, 4, 3)
                         .astype(np.float32))
    want = (x - x.mean((0, 1, 2))) / torch.sqrt(
        x.var((0, 1, 2), correction=0) + 1e-5)
    with collectives.data_parallel_step(1):
        got = bn(x)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert collectives.step_world() == 1 and not collectives.counts
