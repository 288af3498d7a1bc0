"""Port parity: durable checkpoints, resume and retry
(`bigdl_tpu_torch.serialization`, `resilience`, the optimizers' resume and
retry) against `bigdl_tpu`.

- Interchange: a checkpoint the port wrote loads through `bigdl_tpu`'s
  `load_checkpoint` into the JAX model, which then gives the port model's
  eval forward within a relative 1e-5 (f32 convolutions summed in other
  orders); its optimizer blob restores the reference's SGD and its slots
  have the JAX parameter tree's structure. The other way round: the port
  resumes from a checkpoint `bigdl_tpu`'s `LocalOptimizer` wrote, gives
  the JAX model's forward within 1e-5, and its next two steps give the
  reference's losses within a relative 1e-4 (the training-trajectory
  tolerance of `tests/test_torch_optim.py`).
- Durability: a digest mismatch raises `CheckpointCorruptError`,
  `load_latest_valid` quarantines a corrupt newest checkpoint and returns
  the next one, `keep_last_n` prunes, a fault at each `ckpt.*` site leaves
  the previous checkpoints intact, and `memory://` paths work through the
  IO retry policy.
- Resume: k steps, a checkpoint, a new optimizer resumed from it and N-k
  more steps equal N uninterrupted steps bit for bit on the CPU (losses
  and every parameter and buffer), across epoch boundaries with a
  shuffled dataset, for both loops and two methods.
- The adaptive methods: a checkpoint holding `Adagrad`'s or `RMSprop`'s
  accumulators, written by either package, loads in the other and the
  resumed run continues the reference's trajectory (losses within a
  relative 1e-5, parameters within 1e-5 of each tensor's largest element:
  a small MLP, the same f32 arithmetic).
- Retry: `RetryPolicy`'s delays and classes against the reference's for
  the same seed; `DistriOptimizer` recovers from a `train.step` fault
  through the newest checkpoint, and from a failure in the middle of an
  update (before any checkpoint) through its start-of-attempt snapshot,
  both to the unfaulted run bit for bit.
"""

import os
import pickle
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
from bigdl_tpu.nn.module import functional_apply
from bigdl_tpu.resilience import retry as jretry
from bigdl_tpu.serialization import checkpoint as jckpt
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
from bigdl_tpu_torch.interop import (load_module_params, module_params_tree,
                                     module_state, tree_from_named)
from bigdl_tpu_torch.models import ResNet as TResNet
from bigdl_tpu_torch.optim.optimizer import _as_batched_dataset
from bigdl_tpu_torch.resilience import (FaultInjector, FaultSpec,
                                        RetryPolicy, TransientInjectedFault)
from bigdl_tpu_torch.resilience import retry as tretry
from bigdl_tpu_torch.serialization import checkpoint as tckpt
from bigdl_tpu_torch.utils import filesystem as fsys


def _data(n=40, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.rand(n, 16, 16, 3).astype(np.float32)
    y = (rs.randint(0, 10, n) + 1).astype(np.int32)
    return x, y


def _port_model(seed=0):
    return TResNet(10, depth=8, data_set="cifar10", device="cpu",
                   generator=torch.Generator().manual_seed(seed))


def _jax_forward(jm, params, state, x):
    out, _ = functional_apply(jm, jax.tree_util.tree_map(jnp.asarray,
                                                         params),
                              jnp.asarray(x), state=jax.tree_util.tree_map(
                                  jnp.asarray, state), training=False)
    return np.asarray(out)


def _port_forward(tm, x):
    with torch.no_grad():
        return tm.eval()(torch.from_numpy(x)).numpy()


def _close(a, b, rtol=1e-5):
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * np.abs(b).max())


# --------------------------------------------------------------------------
# Interchange with the reference
# --------------------------------------------------------------------------

def test_port_checkpoint_loads_into_the_reference(tmp_path):
    x, y = _data(8)
    tm = _port_model()
    opt = toptim.LocalOptimizer(tm, LocalDataSet([MiniBatch(x, y)]),
                                tnn.ClassNLLCriterion(), device="cpu")
    opt.set_optim_method(toptim.SGD(0.05, momentum=0.9, weight_decay=1e-4))
    opt.set_checkpoint(str(tmp_path), toptim.several_iteration(3))
    opt.set_end_when(toptim.max_iteration(3))
    opt.optimize()
    ckpt = jckpt.latest_checkpoint(str(tmp_path))
    jckpt.verify_checkpoint(ckpt)
    params, state, blob = jckpt.load_checkpoint(ckpt)
    jm = JResNet(10, depth=8, data_set="cifar10")
    jm.ensure_params()
    jm.set_params(jax.tree_util.tree_map(jnp.asarray, params))
    assert jax.tree_util.tree_structure(jm.ensure_params()) == \
        jax.tree_util.tree_structure(params)
    _close(_jax_forward(jm, params, state, x), _port_forward(tm, x))
    method = jckpt.restore_optim_method(joptim.SGD(), blob)
    assert (method.learning_rate, method.momentum, method.weight_decay,
            method.state["neval"]) == (0.05, 0.9, 1e-4, 3)
    assert jax.tree_util.tree_structure(blob["slots"]["velocity"]) == \
        jax.tree_util.tree_structure(params)


def _reference_run(path, steps):
    """The reference's LocalOptimizer on one resident batch, checkpointing
    every 3 steps; its losses and final model."""
    x, y = _data(8, seed=3)
    jm = JResNet(10, depth=8, data_set="cifar10")
    jm.ensure_params()
    opt = joptim.LocalOptimizer(jm, JLocalDataSet([JMiniBatch(x, y)]),
                                jnn.ClassNLLCriterion())
    opt.set_optim_method(joptim.SGD(learning_rate=0.01, momentum=0.9))
    opt.set_checkpoint(path, joptim.several_iteration(3))
    opt.set_end_when(joptim.max_iteration(steps))
    losses = []
    opt.set_iteration_hook(lambda s: losses.append(s["loss"]))
    opt.optimize()
    return losses, x, y


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    path = str(tmp_path / "ref")
    j_losses, x, y = _reference_run(path, 5)
    assert [os.path.basename(p) for p in jckpt.valid_checkpoints(path)] \
        == ["iter3"]
    params, state, blob = jckpt.load_checkpoint(os.path.join(path, "iter3"))
    assert blob["state"]["neval"] == 3
    resume_dir = tmp_path / "resume"
    shutil.copytree(os.path.join(path, "iter3"), resume_dir / "iter3")
    tm = _port_model(seed=9)  # its own weights, replaced by the resume
    opt = toptim.LocalOptimizer(tm, LocalDataSet([MiniBatch(x, y)]),
                                tnn.ClassNLLCriterion(), device="cpu")
    opt.set_optim_method(toptim.SGD())
    opt.set_checkpoint(str(resume_dir), toptim.several_iteration(100))
    assert opt.resume_from_latest_checkpoint()
    assert (opt.optim_method.learning_rate, opt.optim_method.momentum,
            opt.optim_method.state["neval"]) == (0.01, 0.9, 3)
    jm = JResNet(10, depth=8, data_set="cifar10")
    _close(_port_forward(tm, x), _jax_forward(jm, params, state, x))
    slots = tree_from_named(tm, opt._resume_slots["velocity"])
    np.testing.assert_array_equal(
        slots["0_SpatialConvolution"]["weight"],
        blob["slots"]["velocity"]["0_SpatialConvolution"]["weight"])
    losses = []
    opt.set_iteration_hook(lambda s: losses.append(s["loss"]))
    opt.set_end_when(toptim.max_iteration(5))
    opt.optimize()
    np.testing.assert_allclose(losses, j_losses[3:], rtol=1e-4)


def _mlp(pkg, params=None):
    """Sequential(Linear 4->8 "enc", Tanh, Linear 8->3 "dec", LogSoftMax),
    the JAX model with `params` (or its init) and the port's carrying
    them."""
    if pkg is joptim:
        jm = (jnn.Sequential().add(jnn.Linear(4, 8, name="enc"))
              .add(jnn.Tanh()).add(jnn.Linear(8, 3, name="dec"))
              .add(jnn.LogSoftMax()))
        params = params or jax.tree_util.tree_map(
            np.asarray, jm.init(jax.random.PRNGKey(4)))
        jm.set_params(jax.tree_util.tree_map(jnp.asarray, params))
        return jm
    tm = (tnn.Sequential().add(tnn.Linear(4, 8, name="enc", device="cpu"))
          .add(tnn.Tanh()).add(tnn.Linear(8, 3, name="dec", device="cpu"))
          .add(tnn.LogSoftMax()))
    if params is not None:  # else its own weights, until a resume
        load_module_params(tm, params)
    return tm


#: the methods whose slots the interchange carries, with their settings
#: ("per_submodule": Adagrad for "enc", RMSprop for "dec")
SLOT_METHODS = {
    "Adagrad": dict(learning_rate=0.1, learning_rate_decay=0.05,
                    weight_decay=1e-3),
    "RMSprop": dict(learning_rate=0.01, learning_rate_decay=0.05,
                    decay_rate=0.9, weight_decay=1e-3),
    "per_submodule": {},
}


def _set_method(pkg, opt, name):
    if name == "per_submodule":
        opt.set_optim_methods({
            "enc": pkg.Adagrad(**SLOT_METHODS["Adagrad"]),
            "dec": pkg.RMSprop(**SLOT_METHODS["RMSprop"])})
    else:
        opt.set_optim_method(getattr(pkg, name)(**SLOT_METHODS[name]))


def _slot_run(pkg, name, params, path, steps, resume=False):
    """`steps` steps of the MLP under the method `name` on one batch,
    checkpointing every 3 into `path` (or resuming from it first); the
    losses and the optimizer."""
    rs = np.random.RandomState(11)
    x = rs.randn(16, 4).astype(np.float32)
    y = rs.randint(1, 4, 16).astype(np.int32)
    model = _mlp(pkg, params)
    if pkg is joptim:
        opt = joptim.LocalOptimizer(model, JLocalDataSet([JMiniBatch(x, y)]),
                                    jnn.ClassNLLCriterion())
    else:
        opt = toptim.LocalOptimizer(model, LocalDataSet([MiniBatch(x, y)]),
                                    tnn.ClassNLLCriterion(), device="cpu")
    _set_method(pkg, opt, name)
    opt.set_checkpoint(str(path), pkg.several_iteration(3))
    if resume:
        if name != "per_submodule":
            opt.optim_method = getattr(pkg, name)()  # settings: the blob's
        assert opt.resume_from_latest_checkpoint()
        for k, v in SLOT_METHODS[name].items():
            attr = {"decay_rate": "rho"}.get(k, k)
            assert getattr(opt.optim_method, attr) == v
    opt.set_end_when(pkg.max_iteration(steps))
    losses = []
    opt.set_iteration_hook(lambda s: losses.append(s["loss"]))
    opt.optimize()
    return losses, opt


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("name", sorted(SLOT_METHODS))
def test_adaptive_slots_round_trip_with_the_reference(tmp_path, name,
                                                      writer):
    """A checkpoint holding Adagrad's or RMSprop's accumulators (or both,
    one a top-level child, through `set_optim_methods`), written by one
    package after 3 steps, loads in the other: the slots have the
    reference's structure and the writer's values, and the
    resumed run's steps 4-5 give the reference's uninterrupted losses
    (within a relative 1e-5) and parameters (1e-5 of each tensor's
    largest element)."""
    params = jax.tree_util.tree_map(
        np.asarray, _mlp(joptim).init(jax.random.PRNGKey(4)))
    want, jopt = _slot_run(joptim, name, params, tmp_path / "ref", 5)
    wpkg, rpkg = (toptim, joptim) if writer == "port" else (joptim, toptim)
    _slot_run(wpkg, name, params, tmp_path / "w", 3)
    ckpt = jckpt.latest_checkpoint(str(tmp_path / "w"))
    _, _, blob = jckpt.load_checkpoint(ckpt)
    _, _, ref_blob = jckpt.load_checkpoint(
        os.path.join(str(tmp_path / "ref"), "iter3"))
    assert blob["class"] == ref_blob["class"]
    assert blob["state"]["neval"] == 3
    assert jax.tree_util.tree_structure(blob["slots"]) == \
        jax.tree_util.tree_structure(ref_blob["slots"])
    if name != "per_submodule":
        assert jax.tree_util.tree_structure(blob["slots"]["accum"]) == \
            jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(blob["slots"]),
                    jax.tree_util.tree_leaves(ref_blob["slots"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(b)).max())
    got, ropt = _slot_run(rpkg, name, None, tmp_path / "w", 5, resume=True)
    np.testing.assert_allclose(got, want[3:], rtol=1e-5)
    final = module_params_tree(ropt.model) if rpkg is toptim else \
        jax.tree_util.tree_map(np.asarray, ropt.model.ensure_params())
    ref = jax.tree_util.tree_map(np.asarray, jopt.model.ensure_params())
    for a, b in zip(jax.tree_util.tree_leaves(final),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())


# --------------------------------------------------------------------------
# Durability
# --------------------------------------------------------------------------

def _save(path, tag, model=None, method=None):
    model = model or _port_model()
    method = method or toptim.SGD(0.1, momentum=0.9)
    method.state["neval"] = int(tag[4:]) if tag.startswith("iter") else 0
    return tckpt.save_checkpoint(
        str(path), model, module_params_tree(model), module_state(model),
        method, opt_slots=None, tag=tag)


def test_digest_mismatch_raises(tmp_path):
    ckpt = _save(tmp_path, "iter1")
    f = os.path.join(ckpt, "params.pkl")
    blob = bytearray(open(f, "rb").read())
    blob[-10] ^= 0xFF
    open(f, "wb").write(bytes(blob))
    with pytest.raises(tckpt.CheckpointCorruptError):
        tckpt.verify_checkpoint(ckpt)
    with pytest.raises(tckpt.CheckpointCorruptError):
        tckpt.load_checkpoint(ckpt)


def test_load_latest_valid_quarantines_a_corrupt_newest(tmp_path):
    _save(tmp_path, "iter1")
    newest = _save(tmp_path, "iter2")
    f = os.path.join(newest, "optim.pkl")
    blob = bytearray(open(f, "rb").read())
    blob[5:8] = bytes(b ^ 0xFF for b in blob[5:8])
    open(f, "wb").write(bytes(blob))
    got = tckpt.load_latest_valid(str(tmp_path))
    assert got is not None and got[0].endswith("iter1")
    assert got[3]["state"]["neval"] == 1
    assert [os.path.basename(p) for p in tckpt.valid_checkpoints(
        str(tmp_path))] == ["iter1"]
    assert any(d.startswith(".corrupt-iter2") for d in os.listdir(tmp_path))


def test_keep_last_n_prunes_the_oldest(tmp_path):
    model = _port_model()
    for i in range(1, 5):
        method = toptim.SGD()
        method.state["neval"] = i
        tckpt.save_checkpoint(str(tmp_path), model, module_params_tree(model),
                              module_state(model), method, tag=f"iter{i}",
                              keep_last_n=2)
    assert [os.path.basename(p) for p in tckpt.valid_checkpoints(
        str(tmp_path))] == ["iter4", "iter3"]
    with pytest.raises(ValueError):
        tckpt.save_checkpoint(str(tmp_path), model, {}, {}, toptim.SGD(),
                              tag="x", keep_last_n=0)


@pytest.mark.parametrize("site", ["ckpt.write.params", "ckpt.write.state",
                                  "ckpt.write.optim", "ckpt.write.manifest",
                                  "ckpt.commit"])
def test_a_fault_mid_save_leaves_the_previous_set(tmp_path, site):
    _save(tmp_path, "iter1")
    _save(tmp_path, "iter2")
    before = {p: tckpt.verify_checkpoint(p)["files"]
              for p in tckpt.valid_checkpoints(str(tmp_path))}
    with FaultInjector(FaultSpec(site, times=None)) as plan:
        with pytest.raises(TransientInjectedFault):
            _save(tmp_path, "iter3")
        with pytest.raises(TransientInjectedFault):
            _save(tmp_path, "iter2")  # re-saving an existing tag
    assert plan.fired == [(site, 1), (site, 2)]
    after = {p: tckpt.verify_checkpoint(p)["files"]
             for p in tckpt.valid_checkpoints(str(tmp_path))}
    assert after == before
    assert sorted(os.listdir(tmp_path)) == ["iter1", "iter2"]


def test_memory_store_round_trip_through_the_io_retry(monkeypatch):
    sleeps = []
    fsys.set_io_retry_policy(RetryPolicy(max_retries=3, seed=0,
                                         sleep=sleeps.append))
    try:
        model = _port_model()
        with FaultInjector(FaultSpec("fs.remote_io", at_hit=3)) as plan:
            ckpt = tckpt.save_checkpoint("memory://ckpts/run", model,
                                         module_params_tree(model),
                                         module_state(model), toptim.SGD(),
                                         tag="iter7")
        assert plan.fired and len(sleeps) == 1
        assert tckpt.latest_checkpoint("memory://ckpts/run") == ckpt
        params, state, _ = tckpt.load_checkpoint(ckpt)
        want = module_params_tree(model)
        np.testing.assert_array_equal(
            params["0_SpatialConvolution"]["weight"],
            want["0_SpatialConvolution"]["weight"])
        assert fsys.glob("memory://ckpts/run/iter*") == [
            "memory:///ckpts/run/iter7"]
        fsys.rmtree("memory://ckpts")
        assert not fsys.exists("memory://ckpts/run")
    finally:
        fsys.set_io_retry_policy(None)
    with pytest.raises(ImportError, match="s3://"):
        fsys.exists("s3://bucket/ckpt")


def test_set_checkpoint_refuses_what_is_not_ported():
    """`sharded=True` is ported (`sharded_checkpoint.py`, through
    `torch.distributed.checkpoint`) to local paths: a URI is what it
    refuses, at configure time."""
    opt = toptim.LocalOptimizer(_port_model(), LocalDataSet([]),
                                tnn.ClassNLLCriterion(), device="cpu")
    opt.set_checkpoint("x", toptim.several_iteration(1), sharded=True)
    assert opt.checkpoint_sharded and opt.checkpoint_path == "x"
    with pytest.raises(ValueError, match="local path"):
        opt.set_checkpoint("memory://ckpts", toptim.several_iteration(1),
                           sharded=True)
    with pytest.raises(ValueError):
        opt.set_checkpoint("x", toptim.several_iteration(1), keep_last_n=0)


# --------------------------------------------------------------------------
# Resume equals the uninterrupted run, bit for bit
# --------------------------------------------------------------------------

N_STEPS, K = 14, 9  # 5 batches an epoch: the checkpoint sits mid-epoch 2


def _resumable(kind, method, path, seed=0):
    x, y = _data()
    tm = _port_model(seed)
    ds = _as_batched_dataset((x, y), 8, False)
    crit = tnn.ClassNLLCriterion()
    opt = toptim.LocalOptimizer(tm, ds, crit, device="cpu") \
        if kind == "local" else \
        toptim.DistriOptimizer(tm, ds, crit, devices=["cpu"])
    opt.set_optim_method(toptim.SGD(0.1, momentum=0.9) if method == "sgd"
                         else toptim.Adam(1e-3))
    opt.set_gradient_clipping_by_l2_norm(1.0)
    opt.set_checkpoint(str(path), toptim.several_iteration(3),
                       keep_last_n=2)
    opt.set_end_when(toptim.max_iteration(N_STEPS))
    losses = []
    opt.set_iteration_hook(lambda s: losses.append(s["loss"]))
    return tm, opt, losses


@pytest.mark.parametrize("kind", ["local", "distri"])
@pytest.mark.parametrize("method", ["sgd", "adam"])
def test_resume_equals_the_uninterrupted_run(tmp_path, kind, method):
    tm, opt, full = _resumable(kind, method, tmp_path / "a")
    opt.optimize()
    assert [os.path.basename(p) for p in tckpt.valid_checkpoints(
        str(tmp_path / "a"))] == ["iter12", "iter9"]
    shutil.copytree(tmp_path / "a" / f"iter{K}", tmp_path / "b" / f"iter{K}")
    tm2, opt2, rest = _resumable(kind, method, tmp_path / "b", seed=5)
    assert opt2.resume_from_latest_checkpoint()
    opt2.optimize()
    assert rest == full[K:]
    for (k, a), b in zip(tm.state_dict().items(), tm2.state_dict().values()):
        assert torch.equal(a, b), k
    assert opt2.optim_method.state["epoch"] == opt.optim_method.state["epoch"]


def test_resume_without_a_checkpoint_is_false(tmp_path):
    _, opt, _ = _resumable("local", "sgd", tmp_path / "none")
    assert not opt.resume_from_latest_checkpoint()


def test_cursor_round_trips_mid_pass():
    ds = LocalDataSet(list(range(7)), seed=4)
    it = ds.data(train=True)
    first = [next(it) for _ in range(10)]  # one pass and 3 items
    pos = ds.position()
    ds.shuffle()  # an epoch-boundary shuffle in the middle of the pass
    rest = [next(it) for _ in range(2)]
    cur = ds.cursor(pos)
    rest += [next(it) for _ in range(9)]  # into the next pass
    back = LocalDataSet(list(range(7)), seed=99)
    back.restore_cursor(pickle.loads(pickle.dumps(cur)))
    again = back.data(train=True)
    assert cur["shuffles_at"] == [3] and cur["skip"] == 3
    assert [next(again) for _ in range(11)] == rest
    assert sorted(first[:7]) == list(range(7))
    with pytest.raises(ValueError, match="numpy"):
        back.restore_cursor({**cur, "generator": None})
    with pytest.raises(ValueError, match="does not match"):
        LocalDataSet(list(range(5))).restore_cursor(cur)


# --------------------------------------------------------------------------
# Retry
# --------------------------------------------------------------------------

def test_retry_policy_matches_the_reference():
    kw = dict(max_retries=6, base_delay_s=0.05, max_delay_s=1.0, seed=3)
    t, j = RetryPolicy(**kw), jretry.RetryPolicy(**kw)
    assert [t.delay_s(a) for a in range(1, 7)] == \
        [j.delay_s(a) for a in range(1, 7)]
    from bigdl_tpu.resilience import faults as jfaults
    pairs = [(e, e) for e in (OSError(), TimeoutError(), ValueError(),
                              KeyError(), RuntimeError())] + [
        (TransientInjectedFault(), jfaults.TransientInjectedFault()),
        (tretry.PermanentInjectedFault(), jfaults.PermanentInjectedFault())]
    for te, je in pairs:
        assert t.is_transient(te) == j.is_transient(je)


def test_retry_policy_call_and_budget():
    slept, calls = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("blip")
        return "ok"

    assert RetryPolicy(seed=0, sleep=slept.append).call(flaky) == "ok"
    assert len(slept) == 2
    with pytest.raises(ValueError):
        RetryPolicy(sleep=slept.append).call(
            lambda: (_ for _ in ()).throw(ValueError("shape")))
    with pytest.raises(tretry.RetryBudgetExhausted):
        RetryPolicy(base_delay_s=10, budget_s=1e-9, seed=1,
                    sleep=slept.append).call(
            lambda: (_ for _ in ()).throw(OSError("down")))


def _distri(path, retry=True):
    x, y = _data()
    tm = _port_model()
    opt = toptim.Optimizer(
        tm, (x, y), tnn.ClassNLLCriterion(), 8, local=False,
        device="cpu",
        retry_policy=RetryPolicy(max_retries=3, base_delay_s=0.0, seed=0))
    opt.set_optim_method(toptim.SGD(0.1, momentum=0.9))
    opt.set_checkpoint(str(path), toptim.several_iteration(3))
    opt.set_end_when(toptim.max_iteration(10))
    losses = []
    opt.set_iteration_hook(lambda s: losses.append((s["neval"],
                                                    s["loss"])))
    return tm, opt, losses


def test_distri_optimizer_retries_from_the_newest_checkpoint(tmp_path):
    tm, opt, clean = _distri(tmp_path / "clean")
    assert isinstance(opt, toptim.DistriOptimizer)
    opt.optimize()
    tm2, opt2, faulted = _distri(tmp_path / "faulted")
    with FaultInjector(FaultSpec("train.step", at_hit=6)) as plan:
        opt2.optimize()
    assert plan.fired == [("train.step", 6)]
    # steps 1-5, then the retry resumes at iter3: steps 4-10 again
    assert [n for n, _ in faulted] == [1, 2, 3, 4, 5] + list(range(4, 11))
    assert faulted[5:] == clean[3:]
    for a, b in zip(tm.state_dict().values(), tm2.state_dict().values()):
        assert torch.equal(a, b)


def test_distri_optimizer_restores_its_snapshot_before_a_checkpoint(
        tmp_path, monkeypatch):
    x, y = _data(8)

    def build():
        tm = _port_model()
        opt = toptim.DistriOptimizer(
            tm, LocalDataSet([MiniBatch(x, y)]), tnn.ClassNLLCriterion(),
            retry_policy=RetryPolicy(max_retries=1, base_delay_s=0.0),
            devices=["cpu"])
        opt.set_optim_method(toptim.SGD(0.1, momentum=0.9))
        opt.set_checkpoint(str(tmp_path), toptim.several_iteration(100))
        opt.set_end_when(toptim.max_iteration(3))
        return tm, opt

    tm, opt = build()
    opt.optimize()
    tm2, opt2 = build()
    real = toptim.SGD.update
    failed = []

    def half_then_fail(self, grads, opt_state, params, lr):
        if not failed:  # update half the parameters, then fail
            failed.append(1)
            half = dict(list(params.items())[:len(params) // 2])
            real(self, {k: grads[k] for k in half},
                 {"velocity": {k: opt_state["velocity"][k] for k in half}},
                 half, lr)
            raise OSError("lost the device mid-update")
        return real(self, grads, opt_state, params, lr)

    monkeypatch.setattr(toptim.SGD, "update", half_then_fail)
    opt2.optimize()
    assert failed
    for a, b in zip(tm.state_dict().values(), tm2.state_dict().values()):
        assert torch.equal(a, b)


def test_no_retry_without_a_checkpoint_path():
    """As in the reference: without `set_checkpoint` the fault propagates
    at once, and no snapshot is kept (the local loop keeps one and puts
    the model back)."""
    x, y = _data(8)
    for kind in ("distri", "local"):
        tm = _port_model()
        before = {k: v.clone() for k, v in tm.state_dict().items()}
        ds, crit = LocalDataSet([MiniBatch(x, y)]), tnn.ClassNLLCriterion()
        opt = toptim.DistriOptimizer(tm, ds, crit, devices=["cpu"]) \
            if kind == "distri" else \
            toptim.LocalOptimizer(tm, ds, crit, device="cpu")
        opt.set_end_when(toptim.max_iteration(4))
        with FaultInjector(FaultSpec("train.step", at_hit=3)) as plan:
            with pytest.raises(TransientInjectedFault):
                opt.optimize()
        assert plan.fired == [("train.step", 3)]
        assert opt.optim_method.state["neval"] == 2
        assert (opt._pristine is None) == (kind == "distri")
        restored = all(torch.equal(v, before[k])
                       for k, v in tm.state_dict().items())
        assert restored == (kind == "local")


def test_distri_optimizer_signature_refuses_sharding_rules():
    """`sharding_rules` are ported (the reference's fifth positional
    parameter; `ShardingRules()` when None, as the reference's): without a
    model axis they place nothing. What is refused is a model axis that
    does not divide the ranks."""
    from bigdl_tpu_torch.parallel.mesh import process_mesh_shape
    from bigdl_tpu_torch.parallel.sharding import ShardingRules
    rules = ShardingRules(min_shard_dim=16)
    opt = toptim.DistriOptimizer(_port_model(), LocalDataSet([]),
                                 tnn.ClassNLLCriterion(), None, rules,
                                 devices=["cpu"])
    assert opt.rules is rules and opt.model_size == 1
    assert opt.data_size == 1 and opt.sharded is None
    default = toptim.DistriOptimizer(_port_model(), LocalDataSet([]),
                                     tnn.ClassNLLCriterion(),
                                     devices=["cpu"])
    assert default.rules.min_shard_dim == 256
    assert process_mesh_shape(None, 2, 4) == (2, 2)
    with pytest.raises(ValueError, match="does not divide"):
        process_mesh_shape(None, 3, 4)
    with pytest.raises(ValueError, match="2x2 != 8"):
        process_mesh_shape(2, 2, 8)


def test_factory_refuses_retry_settings_for_the_local_loop():
    x, y = _data(8)
    with pytest.raises(TypeError, match="DistriOptimizer"):
        toptim.Optimizer(_port_model(), (x, y), tnn.ClassNLLCriterion(), 8,
                         device="cpu", retry_times=2)
