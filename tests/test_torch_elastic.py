"""Port parity: elastic training (membership, shrink, replay, grow) against
`tests/test_elastic.py` and the JAX `DistriOptimizer`.

The port's elastic loop is single-controller over a device list that may
repeat one device: here `["cpu"] * 2` (or 4), each entry a `Slot` of a
`SimulatedCluster`, the port's stand-in for the JAX tests' virtual CPU
devices.

- The `WorkerRegistry`, fault-site and `ElasticController` units, as the
  reference's (`tests/test_elastic.py:67-186`), slots included.
- The `TestElasticTraining` cases: a shrink, a grow and a collective
  rebuild against the port's own uninterrupted elastic run, bitwise
  (losses and parameters); the floor falling through to the job retry;
  the refusals (a model axis, gradient accumulation, a batch that does
  not divide, `NanGuard("skip")`, a process group); the bounded
  recoveries. Then what the port adds: the bucketing setter leaving the
  bits unchanged; a conv + `SpatialBatchNormalization` model whose running
  statistics after a shrink and replay equal the oracle's bitwise; the
  lead's slot lost, its tensors unreadable, and the lead rebuilt on the
  other device (a replica module until then) from the host commit alone;
  a dropout model whose shard masks survive the remap; the shard
  dispatches on per-worker trace lanes; the LeNet soak.
- Against the JAX package: the `_elastic_linear` shrink, the conv + BN
  model through a shrink and a grow (its running mean and var too) and
  the LeNet soak, the JAX weights carried in through `interop`, the JAX
  run on 2 XLA CPU devices and the port's on `["cpu"] * 2`, both fed by
  one reference `LocalDataSet` per run (the same batch order): the same
  event kinds in the same order with the same `step`, `n_active` and
  `degraded_capacity`, the same step numbers, losses within a relative
  1e-5 and parameters (and running stats) within 1e-5 of each tensor's
  largest element (f32, the same sums in the same order up to the ops'
  own rounding). The soak's chaos run is made once and held both against
  the port's uninterrupted run and against the JAX run.
- `tools/bench.py --device-loss --device cpu` reports a recovery and a
  grow back.
"""

import json

import numpy as np
import pytest
import torch

import jax

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset.dataset import LocalDataSet as JLocalDataSet
from bigdl_tpu.dataset.sample import MiniBatch as JMiniBatch
from bigdl_tpu.models.lenet import LeNet5 as JLeNet5
from bigdl_tpu.observability import InMemorySink as JInMemorySink
from bigdl_tpu.observability import Telemetry as JTelemetry
from bigdl_tpu.optim.distri_optimizer import DistriOptimizer as JDistri
from bigdl_tpu.parallel.mesh import build_mesh as jbuild_mesh
from bigdl_tpu import resilience as jres
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import (LocalDataSet, MiniBatch, Sample,
                                     SampleToMiniBatch)
from bigdl_tpu_torch.interop import (load_module_params, module_params_tree,
                                     module_state)
from bigdl_tpu_torch.models import LeNet5
from bigdl_tpu_torch.observability import (InMemorySink, NanGuard,
                                           SpanTracer, Telemetry)
from bigdl_tpu_torch.parallel import build_mesh
from bigdl_tpu_torch.resilience import (CollectiveError, DeviceLossError,
                                        ElasticController, FaultInjector,
                                        FaultSpec, InsufficientCapacityError,
                                        SimulatedCluster, Slot,
                                        WorkerRegistry, active_injector)
from bigdl_tpu_torch.resilience.faults import known_sites, register_site
from bigdl_tpu_torch.utils.table import Table

pytestmark = pytest.mark.chaos

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small ops: with JAX in the process torch's intra-op pool is
    far slower than one thread (see tests/test_torch_recurrent.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def _no_injector_leak():
    yield
    leaked = active_injector()
    if leaked is not None:
        leaked.uninstall()
        raise AssertionError(f"test leaked an installed FaultInjector: "
                             f"{leaked.specs}")


def _events(sink, kind=None):
    evs = [r for r in sink.records if r.get("type") == "event"]
    return evs if kind is None else [r for r in evs if r["event"] == kind]


def _tel():
    sink = InMemorySink()
    return sink, Telemetry(sink, resources=False, flight=False)


def _lose(*workers):
    return lambda ctx: DeviceLossError("preempted", lost=workers)


def _assert_same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


# -- the units ----------------------------------------------------------------

class TestWorkerRegistry:
    def test_lease_expiry_and_rejoin_in_virtual_time(self):
        now = [0.0]
        sink, tel = _tel()
        reg = WorkerRegistry(lease_s=5.0, clock=lambda: now[0],
                             telemetry=tel)
        reg.register("w0", ["d0"]).register("w1", ["d1", "d2"])
        assert reg.alive() == ["w0", "w1"] and reg.total_devices() == 3
        now[0] = 3.0
        reg.heartbeat("w0")
        assert reg.sweep() == []
        now[0] = 6.0
        assert reg.sweep() == ["w1"]
        assert reg.alive() == ["w0"] and reg.alive_devices() == ["d0"]
        assert reg.degraded_capacity() == pytest.approx(2 / 3)
        lost = _events(sink, "worker_lost")[-1]
        assert lost["worker"] == "w1" and lost["reason"] == "lease_expired"
        assert lost["degraded_capacity"] == pytest.approx(2 / 3)
        assert reg.heartbeat("w1") is True
        rejoin = _events(sink, "worker_joined")[-1]
        assert rejoin["worker"] == "w1" and rejoin["rejoined"] is True
        assert reg.degraded_capacity() == 0.0

    def test_mark_lost_and_device_lookup(self):
        reg = WorkerRegistry(lease_s=100.0)
        reg.register("a", ["dx"]).register("b", ["dy"])
        assert reg.worker_for_device("dy") == "b"
        reg.mark_device_lost("dy")
        assert reg.lost() == ["b"]
        reg.mark_device_lost("unknown-device")
        with pytest.raises(KeyError):
            reg.mark_lost("nope")
        snap = reg.snapshot()
        assert snap["alive"] == 1 and snap["total"] == 2
        assert snap["workers"]["b"]["alive"] is False
        assert reg.remove("a") and not reg.remove("a")

    def test_simulated_cluster_slots_keep_repeated_devices_apart(self):
        cl = SimulatedCluster(2, devices=["cpu"] * 4)
        assert cl.workers() == ["worker0", "worker1"]
        slots = cl.devices()
        assert [s.index for s in slots] == [0, 1, 2, 3]
        assert all(s.device == torch.device("cpu") for s in slots)
        assert cl.assignment["worker0"] == slots[:2]
        # one device, four slots: each slot finds its own worker
        assert [cl.registry.worker_for_device(s) for s in slots] == \
            ["worker0", "worker0", "worker1", "worker1"]
        assert cl.registry.worker_for_device(torch.device("cpu")) is None
        cl.registry.mark_device_lost(slots[3])
        assert cl.registry.alive_devices() == slots[:2]
        assert cl.restore("worker1") is True
        assert SimulatedCluster.shard([0, 1, 2, 3, 4], 1, 2) == [1, 3]
        with pytest.raises(ValueError):
            SimulatedCluster(3, devices=["cpu"] * 2)


class TestSiteRegistry:
    def test_unknown_site_raises_at_spec_build(self):
        with pytest.raises(ValueError, match="not an instrumented site"):
            FaultSpec("train.stpe")

    def test_mesh_sites_are_registered(self):
        assert "mesh.device_loss" in known_sites()
        assert "mesh.collective" in known_sites()
        FaultSpec("mesh.device_loss")

    def test_register_site_extends_the_registry(self):
        name = register_site("testonly.torch_site")
        assert name in known_sites()
        FaultSpec(name)
        with pytest.raises(ValueError, match="subsystem"):
            register_site("nodotname")


class TestElasticController:
    def test_plan_maps_survivors_to_valid_shapes(self):
        slots = SimulatedCluster(4, devices=["cpu"] * 4).devices()
        c = ElasticController(logical_replicas=4, min_devices=2)
        p4 = c.plan(slots)
        assert p4.n_active == 4 and p4.lead is slots[0]
        assert p4.mesh.devices.shape == (4, 1)
        p3 = c.plan(slots[:3], total_devices=4)
        assert p3.n_active == 3
        assert p3.degraded_capacity == pytest.approx(0.25)
        assert ElasticController(logical_replicas=2).plan(slots).n_active \
            == 2
        with pytest.raises(InsufficientCapacityError):
            c.plan(slots[:1])
        assert c.shard_device(p3, 0) is slots[0]
        assert c.shard_device(p3, 3) is slots[0]
        assert c.replay_boundary(7) == 7

    def test_split_batch_equal_shards_and_tables(self):
        c = ElasticController(logical_replicas=4)
        parts = c.split_batch(np.arange(8).reshape(8, 1))
        assert len(parts) == 4 and parts[1][0, 0] == 2
        t = c.split_batch(torch.arange(8).reshape(8, 1))
        assert len(t) == 4 and int(t[3][1, 0]) == 7
        tabs = c.split_batch([np.arange(8), np.arange(8) * 10])
        assert len(tabs) == 4 and isinstance(tabs[0], Table)
        assert int(tabs[2][2][0]) == 40  # 1-based: the second array
        tabs2 = c.split_batch(Table(np.arange(8), np.arange(8) * 10))
        assert len(tabs2) == 4 and isinstance(tabs2[0], Table)
        with pytest.raises(ValueError, match="does not divide"):
            c.split_batch(np.arange(6))
        with pytest.raises(ValueError, match="does not divide"):
            c.split_batch(torch.zeros(6))
        assert c.split_batch(None) == [None] * 4

    def test_ctor_validation(self):
        with pytest.raises(ValueError):
            ElasticController(0)
        with pytest.raises(ValueError):
            ElasticController(2, min_devices=3)


# -- elastic training ---------------------------------------------------------

def _linear_batches(n_batches=6, rows=32):
    rs = np.random.RandomState(0)
    W = np.array([[1.0], [-2.0], [0.5], [3.0]], np.float32)
    xs = [rs.randn(rows, 4).astype(np.float32) for _ in range(n_batches)]
    return [(x, (x @ W).astype(np.float32)) for x in xs]


def _jax_linear():
    jm = jnn.Linear(4, 1, with_bias=False)
    return jm, jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(3)))


def _run(model, dataset, criterion, registry=None, telemetry=None, end=10,
         sync=1, devices=2, setup=None, lr=0.05, device_list=None):
    device_list = device_list or ["cpu"] * devices
    opt = toptim.DistriOptimizer(
        model, dataset, criterion,
        build_mesh(data=len(device_list), devices=device_list),
        retry_times=0)
    opt.set_optim_method(toptim.SGD(learning_rate=lr, momentum=0.9))
    opt.set_end_when(toptim.max_iteration(end))
    opt.set_sync_interval(sync)
    opt.set_elastic(registry=registry)
    if telemetry is not None:
        opt.set_telemetry(telemetry)
    if setup is not None:
        setup(opt)
    losses = {}
    opt.set_iteration_hook(lambda s: losses.__setitem__(s["neval"],
                                                        s["loss"]))
    return opt, losses


def _elastic_linear(registry=None, telemetry=None, end=10, sync=1,
                    dataset=None, setup=None):
    """The reference's `_elastic_linear` on the port: `Linear(4, 1)` from
    the JAX model's PRNGKey(3) weights, 6 batches of 32, MSE, SGD momentum
    0.9, elastic over `["cpu"] * 2`."""
    model = tnn.Linear(4, 1, with_bias=False, device="cpu")
    load_module_params(model, _jax_linear()[1])
    if dataset is None:
        dataset = LocalDataSet([MiniBatch(x, y) for x, y in
                                _linear_batches()])
    opt, losses = _run(model, dataset, tnn.MSECriterion(), registry,
                       telemetry, end, sync, setup=setup)
    return model, opt, losses


class TestElasticTraining:
    def test_device_loss_shrinks_replays_and_matches_oracle(self):
        model_o, opt_o, losses_o = _elastic_linear()
        opt_o.optimize()
        sink, tel = _tel()
        cluster = SimulatedCluster(2, devices=["cpu"] * 2, telemetry=tel)
        model_c, opt_c, losses_c = _elastic_linear(cluster.registry, tel)
        with FaultInjector(FaultSpec("mesh.device_loss", at_hit=4,
                                     exc=_lose("worker1")), telemetry=tel):
            opt_c.optimize()
        assert opt_c.optim_method.state["neval"] == 10
        kinds = [r["event"] for r in _events(sink)]
        order = [kinds.index(k) for k in ("fault_injected", "worker_lost",
                                          "elastic_shrink", "elastic_replay")]
        assert order == sorted(order), kinds
        shrink = _events(sink, "elastic_shrink")[-1]
        assert shrink["n_active_before"] == 2 and shrink["n_active"] == 1
        assert shrink["degraded_capacity"] == pytest.approx(0.5)
        assert _events(sink, "elastic_replay")[-1]["batches"] == 1
        assert opt_c.elastic_stats["recoveries"] == 1
        assert losses_c == losses_o
        _assert_same_state(model_c, model_o)
        starts = [r for r in sink.records if r["type"] == "run_start"]
        assert starts[-1]["loop"] == "distri_elastic"

    def test_capacity_returns_grows_at_boundary_bit_identically(self):
        model_o, opt_o, losses_o = _elastic_linear(end=12)
        opt_o.optimize()
        sink, tel = _tel()
        cluster = SimulatedCluster(2, devices=["cpu"] * 2, telemetry=tel)
        model_c, opt_c, losses_c = _elastic_linear(cluster.registry, tel,
                                                   end=12)
        hook = opt_c.iteration_hook

        def hook2(s):
            hook(s)
            if s["neval"] == 7:
                cluster.restore("worker1")
        opt_c.set_iteration_hook(hook2)
        with FaultInjector(FaultSpec("mesh.device_loss", at_hit=3,
                                     exc=_lose("worker1"))):
            opt_c.optimize()
        grows = _events(sink, "elastic_grow")
        assert grows and grows[-1]["n_active"] == 2
        assert grows[-1]["degraded_capacity"] == 0.0 \
            and grows[-1]["step"] == 7
        assert losses_c == losses_o
        _assert_same_state(model_c, model_o)

    def test_collective_failure_rebuilds_same_size_and_replays(self):
        model_o, opt_o, losses_o = _elastic_linear()
        opt_o.optimize()
        sink, tel = _tel()
        model_c, opt_c, losses_c = _elastic_linear(telemetry=tel)
        with FaultInjector(FaultSpec("mesh.collective", at_hit=5,
                                     exc=CollectiveError)):
            opt_c.optimize()
        assert _events(sink, "elastic_rebuild")
        assert not _events(sink, "elastic_shrink")
        assert losses_c == losses_o
        _assert_same_state(model_c, model_o)

    def test_below_floor_falls_through_to_job_retry(self):
        cluster = SimulatedCluster(2, devices=["cpu"] * 2)
        _, opt_c, _ = _elastic_linear(cluster.registry)
        with FaultInjector(FaultSpec("mesh.device_loss", at_hit=2,
                                     exc=_lose("worker0", "worker1"))):
            with pytest.raises(DeviceLossError):
                opt_c.optimize()

    def test_elastic_requires_data_parallel_mesh(self):
        opt = toptim.DistriOptimizer(
            tnn.Linear(4, 1, device="cpu"), LocalDataSet([]),
            tnn.MSECriterion(),
            build_mesh(data=2, model=2, devices=["cpu"] * 4))
        with pytest.raises(ValueError, match="data-parallel only"):
            opt.set_elastic()

    def test_elastic_refuses_a_process_group(self, monkeypatch):
        from bigdl_tpu_torch.parallel import collectives
        _, opt, _ = _elastic_linear()
        monkeypatch.setattr(collectives, "world_size", lambda: 2)
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            opt.set_elastic()
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            opt.optimize()

    def test_persistent_failure_surfaces_after_bounded_recoveries(self):
        _, opt_c, _ = _elastic_linear()
        opt_c.set_elastic(max_recoveries_per_window=3)
        with FaultInjector(FaultSpec("mesh.collective", times=None,
                                     exc=CollectiveError)) as plan:
            with pytest.raises(CollectiveError):
                opt_c.optimize()
        assert plan.hits("mesh.collective") == 4
        with pytest.raises(ValueError, match="max_recoveries"):
            opt_c.set_elastic(max_recoveries_per_window=0)

    @pytest.mark.parametrize("case", ["accumulation", "indivisible",
                                      "skip_guard", "device_types"])
    def test_refusals_at_optimize(self, case):
        dataset = None
        if case == "indivisible":
            rs = np.random.RandomState(0)
            dataset = LocalDataSet([MiniBatch(
                rs.rand(9, 4).astype(np.float32),
                rs.rand(9, 1).astype(np.float32))])
        _, opt, _ = _elastic_linear(dataset=dataset, end=2)
        if case == "accumulation":
            opt.set_gradient_accumulation(2)
        if case == "skip_guard":
            opt.set_health_monitors(NanGuard("skip"))
        if case == "device_types":
            # a CUDA slot beside the CPU lead (nothing touches the card)
            reg = WorkerRegistry(lease_s=float("inf"))
            reg.register("worker0", [Slot(0, torch.device("cpu"))])
            reg.register("worker1", [Slot(1, torch.device("cuda", 0))])
            opt.set_elastic(registry=reg)
        match = {"accumulation": "gradient accumulation",
                 "indivisible": "does not divide",
                 "skip_guard": "NanGuard",
                 "device_types": "one type"}[case]
        with pytest.raises(ValueError, match=match):
            opt.optimize()

    @pytest.mark.parametrize("bucket_mb", [1e-5, 64.0])
    def test_bucketing_gives_the_barrier_combines_bits(self, bucket_mb):
        """Each shard's gradients go into the running sums in logical
        order whether or not bucketing is set: the setter only reports a
        plan, and the trajectory, with a shrink in it, is the same bits."""
        def conv(setup=None, fault=False):
            model = _conv_bn_net()
            sink, tel = _tel()
            cluster = SimulatedCluster(4, devices=["cpu"] * 4, telemetry=tel)
            opt, losses = _run(model, _conv_data(), tnn.ClassNLLCriterion(),
                               cluster.registry, tel, end=6, devices=4,
                               setup=setup)
            if fault:
                with FaultInjector(FaultSpec("mesh.device_loss", at_hit=3,
                                             exc=_lose("worker3"))):
                    opt.optimize()
            else:
                opt.optimize()
            return model, opt, losses, sink

        model_b, opt_b, losses_b, _ = conv()
        model_k, opt_k, losses_k, sink = conv(
            lambda o: o.set_gradient_bucketing(bucket_mb), fault=True)
        assert losses_k == losses_b
        _assert_same_state(model_k, model_b)
        plan = _events(sink, "bucket_plan")[-1]
        assert (plan["n_buckets"] > 1) == (bucket_mb < 1)

    def test_bn_running_stats_after_shrink_and_replay_equal_oracle(self):
        """Each shard starts from the step's buffers and computes its own
        rows' statistics; the new buffers are averaged in logical order:
        after a shrink (4 -> 3 slots) and a replay of 2 batches the running
        mean and var equal the uninterrupted run's bit for bit."""
        def run(fault):
            model = _conv_bn_net()
            sink, tel = _tel()
            cluster = SimulatedCluster(4, devices=["cpu"] * 4, telemetry=tel)
            opt, losses = _run(model, _conv_data(), tnn.ClassNLLCriterion(),
                               cluster.registry, tel, end=6, sync=2,
                               devices=4)
            if fault:
                with FaultInjector(FaultSpec("mesh.device_loss", at_hit=4,
                                             exc=_lose("worker2"))):
                    opt.optimize()
            else:
                opt.optimize()
            return model, losses, sink

        model_o, losses_o, _ = run(False)
        model_c, losses_c, sink = run(True)
        shrink = _events(sink, "elastic_shrink")[-1]
        assert (shrink["n_active_before"], shrink["n_active"]) == (4, 3)
        assert _events(sink, "elastic_replay")[-1]["batches"] == 2
        np.testing.assert_equal(losses_c, losses_o)
        _assert_same_state(model_c, model_o)
        bn = model_c.children_in_order()[1]
        assert not torch.equal(bn.mean, torch.zeros_like(bn.mean))
        assert not torch.equal(bn.var, torch.ones_like(bn.var))

    def test_losing_the_lead_rebuilds_it_from_the_commit(self):
        """Two distinct devices ("cpu" and "cpu:0"): slot 1 runs a replica
        module. Worker0, the lead, is lost at step 3 and everything it held
        emptied (as a lost card's memory is gone: a copy into it or out of
        it fails): the lead moves to slot 1 from the host commit alone, the step
        generator with it, and back to slot 0 when worker0 returns; the
        run equals the uninterrupted one bit for bit."""
        devs = ["cpu", "cpu:0"]

        def run(fault):
            model = _conv_bn_net()
            sink, tel = _tel()
            cluster = SimulatedCluster(2, devices=devs, telemetry=tel)
            opt, losses = _run(model, _conv_data(), tnn.ClassNLLCriterion(),
                               cluster.registry, tel, end=8, sync=2,
                               device_list=devs)
            if not fault:
                opt.optimize()
                return model, losses, opt, sink
            hook = opt.iteration_hook

            def hook2(s):
                hook(s)
                if s["neval"] == 4:
                    cluster.restore("worker0")
            opt.set_iteration_hook(hook2)

            def lose_lead(ctx):
                with torch.no_grad():
                    for p in model.parameters():
                        p.data = _gone(p)
                    for mod in model.modules():
                        for k, b in mod._buffers.items():
                            if b is not None:
                                mod._buffers[k] = _gone(b)
                    _empty_tree(opt.opt_state)
                return DeviceLossError("preempted", lost=("worker0",))
            with FaultInjector(FaultSpec("mesh.device_loss", at_hit=3,
                                         exc=lose_lead)):
                opt.optimize()
            return model, losses, opt, sink

        model_o, losses_o, opt_o, _ = run(False)
        model_c, losses_c, opt_c, sink = run(True)
        shrink = _events(sink, "elastic_shrink")[-1]
        grow = _events(sink, "elastic_grow")[-1]
        assert (shrink["n_active_before"], shrink["n_active"]) == (2, 1)
        assert (grow["n_active"], grow["step"]) == (2, 4)
        assert opt_c.device == torch.device("cpu")
        np.testing.assert_equal(losses_c, losses_o)
        _assert_same_state(model_c, model_o)
        assert torch.equal(opt_c.generator.get_state(),
                           opt_o.generator.get_state())

    def test_dropout_masks_follow_the_logical_shard(self):
        """Shard i's generator comes from the step's draw and i: after the
        shrink shard 1 runs on slot 0, with the oracle's masks."""
        def run(fault):
            model = (tnn.Sequential()
                     .add(tnn.Linear(8, 32, device="cpu"))
                     .add(tnn.Dropout(0.5))
                     .add(tnn.Linear(32, 3, device="cpu"))
                     .add(tnn.LogSoftMax()))
            torch.manual_seed(0)
            rs = np.random.RandomState(13)
            data = LocalDataSet([MiniBatch(
                rs.randn(8, 8).astype(np.float32),
                (rs.randint(0, 3, 8) + 1).astype(np.int32))
                for _ in range(3)])
            cluster = SimulatedCluster(2, devices=["cpu"] * 2)
            opt, losses = _run(model, data, tnn.ClassNLLCriterion(),
                               cluster.registry, end=6)
            if fault:
                with FaultInjector(FaultSpec("mesh.device_loss", at_hit=4,
                                             exc=_lose("worker1"))):
                    opt.optimize()
            else:
                opt.optimize()
            return model, losses, opt

        model_o, losses_o, opt_o = run(False)
        model_c, losses_c, opt_c = run(True)
        assert opt_c.elastic_stats["recoveries"] == 1
        assert losses_c == losses_o
        _assert_same_state(model_c, model_o)
        assert torch.equal(opt_c.generator.get_state(),
                           opt_o.generator.get_state())

    def test_shard_dispatches_land_on_worker_lanes(self, tmp_path):
        sink, tel = _tel()
        cluster = SimulatedCluster(2, devices=["cpu"] * 2, telemetry=tel)
        _, opt, _ = _elastic_linear(cluster.registry, tel, end=3)
        tracer = SpanTracer(process_name="loop", annotate=False)
        opt.set_tracer(tracer)
        opt.optimize()
        assert set(opt.worker_tracers) == {"worker0", "worker1"}
        with open(opt.export_trace(str(tmp_path / "t.json"))) as f:
            events = json.load(f)["traceEvents"]
        procs = {e["args"]["name"] for e in events
                 if e.get("name") == "process_name"}
        assert {"loop", "worker:worker0", "worker:worker1"} <= procs
        shards = [e for e in events if e.get("name") == "shard dispatch"]
        assert len(shards) == 6
        root = [e for e in events if e.get("name") == "optimize/"
                "distri_elastic"]
        assert root and all(s["args"]["trace_id"] ==
                            root[0]["args"]["trace_id"] for s in shards)


def _gone(t):
    return torch.empty(0, dtype=t.dtype)


def _empty_tree(tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            _empty_tree(v)
        elif isinstance(v, torch.Tensor):
            tree[k] = _gone(v)


def _conv_bn_net():
    torch.manual_seed(0)
    model = (tnn.Sequential()
             .add(tnn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1,
                                         with_bias=False, device="cpu"))
             .add(tnn.SpatialBatchNormalization(4, device="cpu"))
             .add(tnn.ReLU())
             .add(tnn.SpatialMaxPooling(2, 2, 2, 2))
             .add(tnn.Reshape((64,)))
             .add(tnn.Linear(64, 5, device="cpu"))
             .add(tnn.LogSoftMax()))
    return model


def _conv_data():
    """48 samples in batches of 12: an epoch is 4 steps, so a window of
    sync 2 holds 2 batches."""
    rs = np.random.RandomState(11)
    x = rs.rand(48, 8, 8, 3).astype(np.float32)
    y = (rs.randint(0, 5, 48) + 1).astype(np.int32)
    return LocalDataSet([Sample(a, b) for a, b in zip(x, y)],
                        seed=0).transform(SampleToMiniBatch(12))


# -- the LeNet soak -------------------------------------------------------------

SOAK_STEPS = 36


def _soak_batches():
    rs = np.random.RandomState(0)
    return [(rs.rand(16, 28, 28).astype(np.float32),
             (rs.randint(0, 10, 16) + 1).astype(np.int32)) for _ in range(8)]


def _soak_plan(tel, exc):
    lose = lambda ctx: exc[0]("preempted", lost=("worker1",))
    return [FaultSpec("mesh.device_loss", at_hit=4, exc=lose),
            FaultSpec("mesh.device_loss", at_hit=15, exc=lose),
            FaultSpec("mesh.collective", at_hit=28, exc=exc[1])]


def _port_soak(params, registry=None, telemetry=None, hooks=()):
    model = LeNet5(10, device="cpu")
    if params is not None:
        load_module_params(model, params)
    data = JLocalDataSet([JMiniBatch(x.copy(), y.copy())
                          for x, y in _soak_batches()])
    opt, losses = _run(model, data, tnn.ClassNLLCriterion(), registry,
                       telemetry, end=SOAK_STEPS, sync=2)
    hook = opt.iteration_hook

    def all_hooks(s):
        hook(s)
        for fn in hooks:
            fn(s)
    opt.set_iteration_hook(all_hooks)
    return model, opt, losses


def _soak_params():
    return jax.tree_util.tree_map(
        np.asarray, JLeNet5(10).init(jax.random.PRNGKey(1)))


@pytest.fixture(scope="module")
def soak_chaos():
    """The port's soak chaos run, from the JAX weights, made once for the
    two tests that hold it (against the port's uninterrupted run and
    against the JAX run)."""
    sink, tel = _tel()
    cluster = SimulatedCluster(2, devices=["cpu"] * 2, telemetry=tel)

    def rejoin(s):
        if s["neval"] in (8, 20):
            cluster.restore("worker1")
    model, opt, losses = _port_soak(_soak_params(), cluster.registry, tel,
                                    (rejoin,))
    with FaultInjector(*_soak_plan(tel, (DeviceLossError, CollectiveError)),
                       telemetry=tel):
        opt.optimize()
    return model, opt, losses, sink


def test_elastic_soak_repeated_shrink_replay_grow_on_lenet(soak_chaos):
    """The reference's soak: LeNet through two lose -> replay -> rejoin ->
    grow cycles and a collective failure, bitwise against the port's
    uninterrupted elastic run."""
    model_o, opt_o, losses_o = _port_soak(_soak_params())
    opt_o.optimize()
    model_c, opt_c, losses_c, sink = soak_chaos
    assert opt_c.optim_method.state["neval"] == SOAK_STEPS
    assert len(_events(sink, "elastic_shrink")) == 2
    assert len(_events(sink, "elastic_grow")) == 2
    assert _events(sink, "elastic_rebuild")
    assert set(losses_c) == set(losses_o)
    for k in sorted(losses_o):
        np.testing.assert_equal(losses_c[k], losses_o[k])
    _assert_same_state(model_c, model_o)


# -- against the JAX package ----------------------------------------------------

def _jax_events(sink):
    return [r for r in sink.records if r.get("type") == "event"]


def _event_key(r):
    return (r["event"], r.get("step"), r.get("n_active"),
            r.get("degraded_capacity"))


def _close(got, want, params_got, params_want):
    assert sorted(got) == sorted(want)
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k])
        else:
            assert abs(got[k] - want[k]) <= RTOL * abs(want[k]), k
    flat_g = jax.tree_util.tree_leaves(params_got)
    flat_w = jax.tree_util.tree_leaves(params_want)
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        w = np.asarray(w)
        assert np.max(np.abs(np.asarray(g) - w)) <= \
            RTOL * max(np.max(np.abs(w)), 1e-30)


def test_elastic_linear_shrink_matches_jax():
    batches = _linear_batches()
    jm, params0 = _jax_linear()
    jm.set_params(params0)
    jsink = JInMemorySink()
    jtel = JTelemetry(jsink, resources=False, flight=False)
    devs = jax.devices()[:2]
    jcluster = jres.SimulatedCluster(2, devices=devs, telemetry=jtel)
    jopt = JDistri(jm, JLocalDataSet([JMiniBatch(x, y) for x, y in batches]),
                   jnn.MSECriterion(),
                   mesh=jbuild_mesh(data=2, model=1, devices=devs),
                   retry_times=0)
    jopt.set_optim_method(joptim.SGD(learning_rate=0.05, momentum=0.9))
    jopt.set_end_when(joptim.max_iteration(10))
    jopt.set_elastic(registry=jcluster.registry)
    jopt.set_telemetry(jtel)
    jlosses = {}
    jopt.set_iteration_hook(lambda s: jlosses.__setitem__(s["neval"],
                                                          s["loss"]))
    with jres.FaultInjector(jres.FaultSpec(
            "mesh.device_loss", at_hit=4,
            exc=lambda ctx: jres.DeviceLossError("preempted",
                                                 lost=("worker1",))),
            telemetry=jtel):
        jopt.optimize()

    sink, tel = _tel()
    cluster = SimulatedCluster(2, devices=["cpu"] * 2, telemetry=tel)
    model, opt, losses = _elastic_linear(
        cluster.registry, tel,
        dataset=JLocalDataSet([JMiniBatch(x, y) for x, y in batches]))
    with FaultInjector(FaultSpec("mesh.device_loss", at_hit=4,
                                 exc=_lose("worker1")), telemetry=tel):
        opt.optimize()
    assert [_event_key(r) for r in _events(sink)] == \
        [_event_key(r) for r in _jax_events(jsink)]
    _close(losses, jlosses, module_params_tree(model),
           jax.tree_util.tree_map(np.asarray, jm.ensure_params()))


def test_elastic_soak_matches_jax(soak_chaos):
    jm = JLeNet5(10)
    jm.init(jax.random.PRNGKey(1))
    jm.set_params(_soak_params())
    jsink = JInMemorySink()
    jtel = JTelemetry(jsink, resources=False, flight=False)
    devs = jax.devices()[:2]
    jcluster = jres.SimulatedCluster(2, devices=devs, telemetry=jtel)
    jopt = JDistri(jm, JLocalDataSet([JMiniBatch(x.copy(), y.copy())
                                      for x, y in _soak_batches()]),
                   jnn.ClassNLLCriterion(),
                   mesh=jbuild_mesh(data=2, model=1, devices=devs),
                   retry_times=0)
    jopt.set_optim_method(joptim.SGD(learning_rate=0.05, momentum=0.9))
    jopt.set_end_when(joptim.max_iteration(SOAK_STEPS))
    jopt.set_sync_interval(2)
    jopt.set_elastic(registry=jcluster.registry)
    jopt.set_telemetry(jtel)
    jlosses = {}

    def jhook(s):
        jlosses[s["neval"]] = s["loss"]
        if s["neval"] in (8, 20):
            jcluster.restore("worker1")
    jopt.set_iteration_hook(jhook)
    lose = lambda ctx: jres.DeviceLossError("preempted", lost=("worker1",))
    with jres.FaultInjector(
            jres.FaultSpec("mesh.device_loss", at_hit=4, exc=lose),
            jres.FaultSpec("mesh.device_loss", at_hit=15, exc=lose),
            jres.FaultSpec("mesh.collective", at_hit=28,
                           exc=jres.CollectiveError),
            telemetry=jtel):
        jopt.optimize()

    model, opt, losses, sink = soak_chaos
    assert [_event_key(r) for r in _events(sink)] == \
        [_event_key(r) for r in _jax_events(jsink)]
    _close(losses, jlosses, module_params_tree(model),
           jax.tree_util.tree_map(np.asarray, jm.ensure_params()))


def _jax_conv_bn_net():
    return (jnn.Sequential()
            .add(jnn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1,
                                        with_bias=False))
            .add(jnn.SpatialBatchNormalization(4))
            .add(jnn.ReLU())
            .add(jnn.SpatialMaxPooling(2, 2, 2, 2))
            .add(jnn.Reshape((64,)))
            .add(jnn.Linear(64, 5))
            .add(jnn.LogSoftMax()))


def _conv_batches():
    rs = np.random.RandomState(11)
    return [(rs.rand(12, 8, 8, 3).astype(np.float32),
             (rs.randint(0, 5, 12) + 1).astype(np.int32)) for _ in range(4)]


def test_elastic_bn_net_shrink_and_grow_match_jax():
    """The BN handling held to the reference's: the conv + BN model on 2
    devices loses worker1 at step 3 and gets it back at step 4 (sync 2,
    so a replay of one batch and a grow at the step-4 commit); the events,
    the losses, the parameters and the running mean and var agree with the
    JAX `DistriOptimizer`'s elastic run."""
    jm = _jax_conv_bn_net()
    params0 = jax.tree_util.tree_map(np.asarray,
                                     jm.init(jax.random.PRNGKey(5)))
    jm.set_params(params0)
    jsink = JInMemorySink()
    jtel = JTelemetry(jsink, resources=False, flight=False)
    devs = jax.devices()[:2]
    jcluster = jres.SimulatedCluster(2, devices=devs, telemetry=jtel)
    jopt = JDistri(jm, JLocalDataSet([JMiniBatch(x, y)
                                      for x, y in _conv_batches()]),
                   jnn.ClassNLLCriterion(),
                   mesh=jbuild_mesh(data=2, model=1, devices=devs),
                   retry_times=0)
    jopt.set_optim_method(joptim.SGD(learning_rate=0.05, momentum=0.9))
    jopt.set_end_when(joptim.max_iteration(8))
    jopt.set_sync_interval(2)
    jopt.set_elastic(registry=jcluster.registry)
    jopt.set_telemetry(jtel)
    jlosses = {}

    def jhook(s):
        jlosses[s["neval"]] = s["loss"]
        if s["neval"] == 4:
            jcluster.restore("worker1")
    jopt.set_iteration_hook(jhook)
    with jres.FaultInjector(jres.FaultSpec(
            "mesh.device_loss", at_hit=3,
            exc=lambda ctx: jres.DeviceLossError("preempted",
                                                 lost=("worker1",))),
            telemetry=jtel):
        jopt.optimize()

    model = _conv_bn_net()
    load_module_params(model, params0)
    sink, tel = _tel()
    cluster = SimulatedCluster(2, devices=["cpu"] * 2, telemetry=tel)
    opt, losses = _run(model, JLocalDataSet([JMiniBatch(x, y) for x, y in
                                             _conv_batches()]),
                       tnn.ClassNLLCriterion(), cluster.registry, tel,
                       end=8, sync=2)
    hook = opt.iteration_hook

    def hook2(s):
        hook(s)
        if s["neval"] == 4:
            cluster.restore("worker1")
    opt.set_iteration_hook(hook2)
    with FaultInjector(FaultSpec("mesh.device_loss", at_hit=3,
                                 exc=_lose("worker1")), telemetry=tel):
        opt.optimize()
    kinds = [r["event"] for r in _events(sink)]
    assert "elastic_shrink" in kinds and "elastic_grow" in kinds
    assert [_event_key(r) for r in _events(sink)] == \
        [_event_key(r) for r in _jax_events(jsink)]
    _close(losses, jlosses, module_params_tree(model),
           jax.tree_util.tree_map(np.asarray, jm.ensure_params()))
    got, want = module_state(model), jax.device_get(jm._state)
    assert set(got) == set(want)
    for path in want:
        for k in ("mean", "var"):
            w = np.asarray(want[path][k])
            assert np.max(np.abs(got[path][k] - w)) <= \
                RTOL * np.max(np.abs(w)), (path, k)
        assert not np.array_equal(got[path]["mean"],
                                  np.zeros_like(got[path]["mean"]))


def test_bench_chaos_device_loss_reports_recovery(capsys):
    from bigdl_tpu_torch.tools.bench import bench_chaos_device_loss
    out = bench_chaos_device_loss(lose_at=3, rejoin_at=6, iters=10,
                                  batch_size=32, n_samples=256,
                                  device="cpu")
    assert out["metric"] == "chaos_device_loss"
    assert out["recovered"] is True and out["grew_back"] is True
    assert out["mttr_s"] is not None and out["mttr_s"] > 0
    assert out["replayed_batches"] >= 1
    assert out["final_step"] == 10
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line)["metric"] == "chaos_device_loss"


def test_bench_chaos_crash_reports_mttr(capsys):
    from bigdl_tpu_torch.tools.bench import bench_chaos
    out = bench_chaos(crash_at=6, iters=10, ckpt_every=4, batch_size=32,
                      n_samples=256, device="cpu")
    assert out["metric"] == "chaos_mttr" and out["recovered"] is True
    assert out["retries"] == 1 and out["final_step"] == 10
    assert out["lost_iterations"] == 1  # the reload point is iter4
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line)["metric"] == "chaos_mttr"
