"""Port parity: preemption (SIGTERM -> checkpoint -> drain -> clean stop)
against `tests/test_elastic.py` `TestPreemption` and the JAX optimizers.

For `LocalOptimizer`, `DistriOptimizer` at world size 1 and the elastic
loop: the iteration hook raises SIGTERM; `optimize()` returns at that
step without raising, with one `preempted` event (`checkpointed`,
`signal`, `grace_remaining_s`), a `run_abort` and no `run_end`; the
checkpoint (format v2) holds the data cursor and the loop state; the
SIGTERM disposition is restored; a fresh optimizer that resumes from it
ends with the uninterrupted run's losses and parameters bit for bit; the
latch clears, so a second `optimize()` trains; with no checkpoint path
the stop is still clean. The handler's grace window runs in virtual
time, a second signal chains to the previous handler, and `install()` off
the main thread does nothing. Against the JAX package: the same scenario
stops at the same step and its checkpoint's loop counters equal the JAX
run's. The two-rank case (SIGTERM on rank 1 only) is in
`tests/test_torch_distributed.py`'s `runs` launch.
"""

import signal
import threading

import numpy as np
import pytest
import torch

import jax

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset.dataset import LocalDataSet as JLocalDataSet
from bigdl_tpu.dataset.sample import MiniBatch as JMiniBatch
from bigdl_tpu.optim.distri_optimizer import DistriOptimizer as JDistri
from bigdl_tpu.optim.local_optimizer import LocalOptimizer as JLocal
from bigdl_tpu.parallel.mesh import build_mesh as jbuild_mesh
from bigdl_tpu.serialization.checkpoint import \
    load_latest_valid as jload_latest_valid
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
from bigdl_tpu_torch.interop import load_module_params
from bigdl_tpu_torch.observability import InMemorySink, Telemetry
from bigdl_tpu_torch.parallel import build_mesh
from bigdl_tpu_torch.resilience import PreemptionHandler
from bigdl_tpu_torch.serialization import load_latest_valid

pytestmark = pytest.mark.chaos

COUNTERS = ("neval", "epoch", "recordsProcessedThisEpoch")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def _sigterm_back():
    """Every test leaves SIGTERM's disposition as it found it."""
    prior = signal.getsignal(signal.SIGTERM)
    yield
    assert signal.getsignal(signal.SIGTERM) == prior
    signal.signal(signal.SIGTERM, prior)


def _events(sink, kind):
    return [r for r in sink.records
            if r.get("type") == "event" and r["event"] == kind]


def _mlp_batches():
    rs = np.random.RandomState(0)
    return [(rs.rand(16, 6).astype(np.float32),
             (rs.randint(0, 3, 16) + 1).astype(np.int32)) for _ in range(4)]


def _jax_mlp():
    jm = (jnn.Sequential().add(jnn.Linear(6, 8)).add(jnn.Tanh())
          .add(jnn.Linear(8, 3)).add(jnn.LogSoftMax()))
    return jm, jax.tree_util.tree_map(np.asarray,
                                      jm.init(jax.random.PRNGKey(9)))


_JAX_MLP = {}


def _mlp_params():
    if not _JAX_MLP:
        _JAX_MLP["params"] = _jax_mlp()[1]
    return _JAX_MLP["params"]


def _sigterm_at(n, then=None):
    def hook(s):
        if then is not None:
            then(s)
        if s["neval"] == n:
            signal.raise_signal(signal.SIGTERM)
    return hook


def _port_mlp(kind, ckpt=None, end=10, preempt=True, telemetry=None):
    """The reference's `_local_mlp` on the port (JAX PRNGKey(9) weights,
    4 batches of 16, SGD momentum 0.9) through `kind`: "local", "distri"
    (one rank) or "elastic" (two slots of the CPU). Returns the model, the
    optimizer and the dict of losses its hook fills."""
    model = (tnn.Sequential().add(tnn.Linear(6, 8, device="cpu"))
             .add(tnn.Tanh()).add(tnn.Linear(8, 3, device="cpu"))
             .add(tnn.LogSoftMax()))
    load_module_params(model, _mlp_params())
    data = LocalDataSet([MiniBatch(x, y) for x, y in _mlp_batches()])
    crit = tnn.ClassNLLCriterion()
    if kind == "local":
        opt = toptim.LocalOptimizer(model, data, crit, 16, device="cpu")
    elif kind == "distri":
        opt = toptim.DistriOptimizer(model, data, crit, devices=["cpu"],
                                     retry_times=0)
    else:
        opt = toptim.DistriOptimizer(
            model, data, crit, build_mesh(data=2, devices=["cpu"] * 2),
            retry_times=0).set_elastic()
    opt.set_optim_method(toptim.SGD(learning_rate=0.1, momentum=0.9))
    opt.set_end_when(toptim.max_iteration(end))
    if ckpt is not None:
        opt.set_checkpoint(str(ckpt), toptim.several_iteration(1000))
    if preempt:
        opt.set_preemption_handler(grace_s=30.0)
    if telemetry is not None:
        opt.set_telemetry(telemetry)
    losses = {}
    opt.set_iteration_hook(lambda s: losses.__setitem__(s["neval"],
                                                        s["loss"]))
    return model, opt, losses


KINDS = ["local", "distri", "elastic"]


@pytest.mark.parametrize("kind", KINDS)
def test_sigterm_checkpoints_drains_and_aborts_cleanly(kind, tmp_path):
    prior = signal.getsignal(signal.SIGTERM)
    sink = InMemorySink()
    _, opt, _ = _port_mlp(kind, ckpt=tmp_path, telemetry=Telemetry(
        sink, resources=False, flight=False))
    opt.set_iteration_hook(_sigterm_at(6))
    opt.optimize()  # returns: no exception
    assert opt.optim_method.state["neval"] == 6
    pre = _events(sink, "preempted")
    assert len(pre) == 1 and pre[0]["checkpointed"] is True
    assert pre[0]["signal"] == signal.SIGTERM and pre[0]["step"] == 6
    assert 0 < pre[0]["grace_remaining_s"] <= 30.0
    aborts = _events(sink, "run_abort")
    assert aborts and "preempted" in aborts[-1]["error"]
    assert sink.records.index(pre[0]) < sink.records.index(aborts[-1])
    assert not [r for r in sink.records if r.get("type") == "run_end"]
    assert signal.getsignal(signal.SIGTERM) == prior
    got = load_latest_valid(str(tmp_path))
    assert got is not None
    ckpt_dir, _, _, oblob = got
    assert ckpt_dir.endswith("iter6")
    assert oblob["cursor"] is not None
    assert oblob["state"]["neval"] == 6


@pytest.mark.parametrize("kind", KINDS)
def test_preempted_run_resumes_bit_identically(kind, tmp_path):
    model_o, opt_o, losses_o = _port_mlp(kind, preempt=False)
    opt_o.optimize()
    _, opt_p, _ = _port_mlp(kind, ckpt=tmp_path)
    opt_p.set_iteration_hook(_sigterm_at(6))
    opt_p.optimize()
    model_r, opt_r, losses_r = _port_mlp(kind, ckpt=tmp_path, preempt=False)
    assert opt_r.resume_from_latest_checkpoint()
    opt_r.optimize()
    assert losses_r == {k: v for k, v in losses_o.items() if k > 6}
    for a, b in zip(model_r.state_dict().values(),
                    model_o.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", KINDS)
def test_latch_clears_so_train_more_trains(kind, tmp_path):
    _, opt, _ = _port_mlp(kind, ckpt=tmp_path)
    opt.set_iteration_hook(_sigterm_at(3))
    opt.optimize()
    assert opt.optim_method.state["neval"] == 3
    opt.set_iteration_hook(None)
    opt.optimize()
    assert opt.optim_method.state["neval"] == 10


def test_preemption_without_checkpoint_is_still_clean():
    sink = InMemorySink()
    _, opt, _ = _port_mlp("local", telemetry=Telemetry(
        sink, resources=False, flight=False))
    opt.set_iteration_hook(_sigterm_at(3))
    opt.optimize()
    pre = _events(sink, "preempted")
    assert pre and pre[-1]["checkpointed"] is False
    assert _events(sink, "run_abort")


def test_no_handler_leaves_the_run_alone():
    _, opt, losses = _port_mlp("distri", preempt=False)
    opt.set_preemption_handler(grace_s=5.0)
    opt.set_preemption_handler(handler=False)
    opt.optimize()
    assert sorted(losses) == list(range(1, 11))


def test_handler_grace_window_in_virtual_time():
    now = [0.0]
    h = PreemptionHandler(grace_s=10.0, clock=lambda: now[0])
    assert h.deadline_remaining() is None
    h._on_signal(signal.SIGTERM, None)
    now[0] = 4.0
    assert h.deadline_remaining() == pytest.approx(6.0)
    assert h.triggered and h.signum == signal.SIGTERM
    h.reset()
    assert not h.triggered
    with pytest.raises(ValueError):
        PreemptionHandler(grace_s=0)


def test_second_signal_chains_to_the_previous_handler():
    seen = []
    prior = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        with PreemptionHandler() as h:
            signal.raise_signal(signal.SIGTERM)
            assert h.triggered and seen == []
            signal.raise_signal(signal.SIGTERM)
            assert seen == [signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, prior)


def test_install_off_the_main_thread_does_nothing():
    prior = signal.getsignal(signal.SIGTERM)
    h = PreemptionHandler()
    t = threading.Thread(target=h.install)
    t.start()
    t.join()
    assert not h._installed
    assert signal.getsignal(signal.SIGTERM) == prior
    h.uninstall()


def _jax_run(kind, ckpt):
    """The reference's scenario: SIGTERM at step 6 of 10, checkpointed."""
    jm, params = _jax_mlp()
    jm.set_params(params)
    data = JLocalDataSet([JMiniBatch(x, y) for x, y in _mlp_batches()])
    crit = jnn.ClassNLLCriterion()
    if kind == "local":
        opt = JLocal(jm, data, crit, 16)
    else:
        devs = jax.devices()[:1 if kind == "distri" else 2]
        opt = JDistri(jm, data, crit, retry_times=0,
                      mesh=jbuild_mesh(data=len(devs), model=1,
                                       devices=devs))
        if kind == "elastic":
            opt.set_elastic()
    opt.set_optim_method(joptim.SGD(learning_rate=0.1, momentum=0.9))
    opt.set_end_when(joptim.max_iteration(10))
    opt.set_checkpoint(str(ckpt), joptim.several_iteration(1000))
    opt.set_preemption_handler(grace_s=30.0)
    opt.set_iteration_hook(_sigterm_at(6))
    opt.optimize()
    return opt


@pytest.mark.parametrize("kind", KINDS)
def test_stop_step_and_checkpoint_state_match_jax(kind, tmp_path):
    jopt = _jax_run(kind, tmp_path / "jax")
    _, opt, _ = _port_mlp(kind, ckpt=tmp_path / "port")
    opt.set_iteration_hook(_sigterm_at(6))
    opt.optimize()
    assert opt.optim_method.state["neval"] == \
        jopt.optim_method.state["neval"] == 6
    jstate = jload_latest_valid(str(tmp_path / "jax"))[3]["state"]
    state = load_latest_valid(str(tmp_path / "port"))[3]["state"]
    assert {k: state[k] for k in COUNTERS} == \
        {k: jstate[k] for k in COUNTERS}
