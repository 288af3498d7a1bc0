"""Port parity: `bigdl_tpu_torch.optim` against `bigdl_tpu.optim`.

- `SGD` (plain, momentum with the default dampening, nesterov, weight
  decay, the `Default` learning-rate decay) against the JAX update on a
  small tree, step by step;
- the f32 masters of `init_state_with_masters` / `update_with_masters`
  for bf16 parameters;
- a 5-step training run of the CIFAR ResNet-8 (carried JAX weights, one
  resident batch) through the port's `LocalOptimizer` and single-device
  `DistriOptimizer`, against the JAX `LocalOptimizer`: the loss at every
  step and the final BN running stats.

- the rest of the loop: `LAMB`, `Adagrad`, `Adadelta`, `Adamax`,
  `RMSprop`, `Ftrl` and `LBFGS` over 5 updates, in f32 and with bf16
  masters; every schedule's learning rate over 30 iterations; `Plateau`
  fed by validation through the loop; `set_optim_methods` on a two-child
  model in both loops; `LBFGS.optimize_full_batch` on a quadratic; the
  transformer chains and padded batches.

Inputs come from numpy with a fixed seed. Tolerances:
- SGD: rtol 1e-6 (the same f32 operations in the same order; XLA may
  contract a multiply-add where PyTorch rounds twice);
- bf16 masters: the f32 masters to rtol 1e-6, the bf16 parameters to one
  bf16 ulp (2**-8 relative), where a master sits on a rounding tie;
- training in f32: rtol 1e-4 on the losses and the running stats (the
  convolutions sum their terms in other orders, and 5 SGD steps carry
  that into the weights);
- training in "bfloat16": rtol 1e-2 on the losses and the running stats
  (measured on the CPU: 1.7e-3 and 9e-4). Every convolution and BN
  output is rounded to bf16 (2**-8 relative) after an accumulation whose
  order and width differ between oneDNN and XLA, so single bf16 roundings
  land on different sides, and 5 steps of momentum SGD carry those
  differences on;
- the other methods: 1e-5 of each tensor's largest element for the
  parameters (the masters in bf16) and slots, one bf16 ulp for bf16
  parameters (the rounding of a master on a tie); learning rates to
  1e-12 relative (the same float64 arithmetic); the per-submodule and
  Plateau runs' losses within a relative 1e-5; L-BFGS's point within
  1e-4 relative of the reference's.
"""

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
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
from bigdl_tpu_torch.interop import (load_module_params, module_params_tree,
                                     module_state)
from bigdl_tpu_torch.models import ResNet as TResNet

SHAPES = {"w": (3, 4), "b": (4,), "k": (2, 2, 3)}


def _tree(seed, dtype=np.float32):
    rs = np.random.RandomState(seed)
    return {k: rs.randn(*s).astype(dtype) for k, s in SHAPES.items()}


def _j(tree, dtype=jnp.float32):
    return {k: jnp.asarray(v).astype(dtype) for k, v in tree.items()}


def _t(tree, dtype=torch.float32):
    return {k: torch.from_numpy(np.array(v)).to(dtype)
            for k, v in tree.items()}


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


SGD_CONFIGS = {
    "plain": dict(learning_rate=0.1),
    "momentum, default dampening": dict(learning_rate=0.1, momentum=0.9),
    "nesterov": dict(learning_rate=0.1, momentum=0.9, dampening=0.0,
                     nesterov=True),
    "weight decay": dict(learning_rate=0.05, momentum=0.5,
                         weight_decay=1e-2),
    "lr decay": dict(learning_rate=0.1, learning_rate_decay=0.5,
                     momentum=0.9),
}


class TestSGD:
    @pytest.mark.parametrize("cfg", list(SGD_CONFIGS))
    def test_update_matches_jax(self, cfg):
        kw = SGD_CONFIGS[cfg]
        jsgd, tsgd = joptim.SGD(**kw), toptim.SGD(**kw)
        p0 = _tree(0)
        jp, tp = _j(p0), _t(p0)
        js, ts = jsgd.init_state(jp), tsgd.init_state(tp)
        for step in range(3):
            g = _tree(10 + step)
            jlr, tlr = jsgd.current_lr(), tsgd.current_lr()
            assert tlr == jlr
            jp, js = jsgd.update(_j(g), js, jp, jlr)
            tp, ts = tsgd.update(_t(g), ts, tp, tlr)
            jsgd.state["neval"] += 1
            tsgd.state["neval"] += 1
            for k in SHAPES:
                np.testing.assert_allclose(_np(tp[k]), _np(jp[k]),
                                           rtol=1e-6, atol=1e-7,
                                           err_msg=f"{cfg} step {step} {k}")
                if "velocity" in js:
                    np.testing.assert_allclose(
                        _np(ts["velocity"][k]), _np(js["velocity"][k]),
                        rtol=1e-6, atol=1e-7)
        assert ("velocity" in ts) == ("velocity" in js)

    def test_dampening_defaults_to_momentum(self):
        """v = m*v + (1-m)*g, not torch.optim.SGD's v = m*v + g."""
        sgd = toptim.SGD(learning_rate=1.0, momentum=0.9)
        assert sgd.dampening == 0.9
        p = {"w": torch.zeros(2)}
        st = sgd.init_state(p)
        sgd.update({"w": torch.ones(2)}, st, p, 1.0)
        torch.testing.assert_close(st["velocity"]["w"], torch.full((2,), 0.1))
        torch.testing.assert_close(p["w"], torch.full((2,), -0.1))

    def test_nesterov_needs_momentum_and_no_dampening(self):
        for kw in (dict(nesterov=True), dict(nesterov=True, momentum=0.9)):
            with pytest.raises(ValueError, match="Nesterov"):
                toptim.SGD(**kw)
            with pytest.raises(ValueError, match="Nesterov"):
                joptim.SGD(**kw)


class TestMasters:
    def test_f32_params_get_no_masters(self):
        sgd = toptim.SGD(learning_rate=0.1, momentum=0.9)
        st = sgd.init_state_with_masters(_t(_tree(0)))
        assert set(st) == {"velocity"}

    def test_bf16_params_match_jax(self):
        kw = dict(learning_rate=0.1, momentum=0.9)
        jsgd, tsgd = joptim.SGD(**kw), toptim.SGD(**kw)
        p0 = _tree(1)
        jp, tp = _j(p0, jnp.bfloat16), _t(p0, torch.bfloat16)
        js = jsgd.init_state_with_masters(jp)
        ts = tsgd.init_state_with_masters(tp)
        key = toptim.OptimMethod._MASTER_KEY
        assert set(ts) == set(js) == {key, "slots"}
        for step in range(3):
            g = _tree(20 + step)
            jp, js = jsgd.update_with_masters(_j(g, jnp.bfloat16), js, jp,
                                              0.1)
            tp, ts = tsgd.update_with_masters(_t(g, torch.bfloat16), ts, tp,
                                              0.1)
            for k in SHAPES:
                assert tp[k].dtype == torch.bfloat16
                assert ts[key][k].dtype == torch.float32
                np.testing.assert_allclose(_np(ts[key][k]), _np(js[key][k]),
                                           rtol=1e-6, atol=1e-7)
                np.testing.assert_allclose(_np(tp[k]), _np(jp[k]),
                                           rtol=2.0 ** -8, atol=0)

    def test_masters_keep_steps_below_half_a_bf16_ulp(self):
        """100 steps of 1e-3 on a weight of 1.0 (half a bf16 ulp there is
        2**-8): a bare bf16 update would never move it."""
        sgd = toptim.SGD(learning_rate=1e-3)
        p = {"w": torch.ones(3, dtype=torch.bfloat16)}
        st = sgd.init_state_with_masters(p)
        for _ in range(100):
            sgd.update_with_masters({"w": torch.ones(3, dtype=torch.bfloat16)},
                                    st, p, 1e-3)
        torch.testing.assert_close(st[sgd._MASTER_KEY]["w"],
                                   torch.full((3,), 0.9), rtol=1e-5,
                                   atol=0)
        assert float(p["w"][0]) == pytest.approx(0.9, abs=2 ** -8)


# --------------------------------------------------------------------------
# 5 training steps of the CIFAR ResNet-8, port against JAX
# --------------------------------------------------------------------------

STEPS = 5


def _batch():
    rs = np.random.RandomState(7)
    x = rs.rand(4, 16, 16, 3).astype(np.float32)
    y = (rs.randint(0, 10, size=4) + 1).astype(np.int32)
    return x, y


def _jax_model():
    jm = JResNet(10, depth=8, data_set="cifar10")
    jm.ensure_params()
    return jm


@pytest.fixture(scope="module")
def jax_runs():
    """{precision: (losses, final BN state, initial params, initial
    state)} of the JAX LocalOptimizer, computed once per precision."""
    cache = {}

    def run(precision):
        if precision not in cache:
            jm = _jax_model()
            params0 = jax.tree_util.tree_map(np.asarray, jm.ensure_params())
            state0 = jax.tree_util.tree_map(np.asarray, jm._state)
            x, y = _batch()
            opt = joptim.LocalOptimizer(jm, JLocalDataSet([JMiniBatch(x, y)]),
                                        jnn.ClassNLLCriterion())
            opt.set_optim_method(joptim.SGD(learning_rate=0.01,
                                            momentum=0.9))
            opt.set_end_when(joptim.max_iteration(STEPS))
            if precision:
                opt.set_compute_precision(precision)
            losses = []
            opt.set_iteration_hook(lambda s: losses.append(s["loss"]))
            opt.optimize()
            state = jax.tree_util.tree_map(np.asarray, jm._state)
            cache[precision] = (losses, state, params0, state0)
        return cache[precision]

    return run


def _port_run(kind, precision, params0, state0):
    tm = TResNet(10, depth=8, data_set="cifar10", device="cpu")
    load_module_params(tm, params0, state0)
    x, y = _batch()
    ds = LocalDataSet([MiniBatch(x, y)])
    crit = tnn.ClassNLLCriterion()
    if kind == "local":
        opt = toptim.LocalOptimizer(tm, ds, crit, device="cpu")
    else:
        opt = toptim.DistriOptimizer(tm, ds, crit, devices=["cpu"])
    opt.set_optim_method(toptim.SGD(learning_rate=0.01, momentum=0.9))
    opt.set_end_when(toptim.max_iteration(STEPS))
    if precision:
        opt.set_compute_precision(precision)
    losses = []
    opt.set_iteration_hook(lambda s: losses.append(s["loss"]))
    opt.optimize()
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    return losses, module_state(tm)


@pytest.mark.parametrize("kind", ["local", "distri"])
@pytest.mark.parametrize("precision,rtol_loss,rtol_state", [
    (None, 1e-4, 1e-4), ("bfloat16", 1e-2, 1e-2)])
def test_training_trajectory_matches_jax(jax_runs, kind, precision,
                                         rtol_loss, rtol_state):
    j_losses, j_state, params0, state0 = jax_runs(precision)
    t_losses, t_state = _port_run(kind, precision, params0, state0)
    assert len(t_losses) == len(j_losses) == STEPS
    assert np.all(np.isfinite(t_losses))
    np.testing.assert_allclose(t_losses, j_losses, rtol=rtol_loss)
    assert set(t_state) == set(j_state)
    for path in j_state:
        for k in ("mean", "var"):
            want = j_state[path][k]
            np.testing.assert_allclose(
                t_state[path][k], want, rtol=0,
                atol=rtol_state * max(np.abs(want).max(), 1e-6),
                err_msg=f"{path} {k}")


def test_training_fits_the_resident_batch():
    """Port-built weights (no carry): the loss falls over 10 steps."""
    tm = TResNet(10, depth=8, data_set="cifar10", device="cpu",
                 generator=torch.Generator().manual_seed(2))
    x, y = _batch()
    opt = toptim.DistriOptimizer(tm, LocalDataSet([MiniBatch(x, y)]),
                                 tnn.ClassNLLCriterion(), devices=["cpu"])
    opt.set_optim_method(toptim.SGD(learning_rate=0.05, momentum=0.9))
    opt.set_end_when(toptim.max_iteration(10))
    opt.set_compute_precision("bfloat16")
    opt.set_sync_interval(5)
    losses = []
    opt.set_iteration_hook(lambda s: losses.append(float(opt.last_loss)))
    opt.optimize()
    assert opt.optim_method.state["neval"] == 10
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_distri_optimizer_takes_one_device_only():
    # several devices in one process train only in elastic mode: the
    # plain loop refuses them when it starts
    tm = TResNet(10, depth=8, data_set="cifar10", device="cpu")
    opt = toptim.DistriOptimizer(tm, LocalDataSet([]),
                                 tnn.ClassNLLCriterion(),
                                 devices=["cpu", "cpu"])
    with pytest.raises(NotImplementedError, match="one process per GPU"):
        opt.optimize()


def test_compute_precision_is_checked():
    tm = TResNet(10, depth=8, data_set="cifar10", device="cpu")
    opt = toptim.LocalOptimizer(tm, LocalDataSet([]),
                                tnn.ClassNLLCriterion(), device="cpu")
    with pytest.raises(ValueError, match="compute precision"):
        opt.set_compute_precision("float16")


@pytest.mark.parametrize("trigger,fires", [
    (lambda: toptim.max_iteration(3), [False, False, False, True, True]),
    (lambda: toptim.several_iteration(2), [False, False, True, False, True]),
])
def test_iteration_triggers(trigger, fires):
    t = trigger()
    assert [t({"neval": n, "epoch": 0}) for n in range(5)] == fires


def test_epoch_triggers():
    assert [toptim.max_epoch(2)({"epoch": e}) for e in range(4)] == \
        [False, False, True, True]
    every = toptim.every_epoch()
    assert [every({"epoch": e}) for e in (0, 1, 1, 2)] == \
        [False, True, False, True]


def test_local_dataset_order_comes_from_its_generator():
    items = list(range(6))

    def first_pass(seed):
        it = LocalDataSet(items, generator=torch.Generator().manual_seed(
            seed)).data(train=True)
        return [next(it) for _ in items]

    assert first_pass(3) == first_pass(3)
    assert sorted(first_pass(3)) == items
    assert list(LocalDataSet(items).data(train=False)) == items


def test_framework_throughput_reports_every_step():
    """The benchmark's timing loop on the CPU: whole sync windows, one
    loss a step, a positive rate."""
    from bigdl_tpu_torch.tools.bench import framework_throughput
    tm = TResNet(10, depth=8, data_set="cifar10", device="cpu")
    res = framework_throughput(tm, (16, 16, 3), 10, batch_size=2, warmup=2,
                               iters=4, sync=2, device="cpu")
    assert (res["steps"], res["sync"], res["device"]) == (6, 2, "cpu")
    assert len(res["losses"]) == 6 and np.all(np.isfinite(res["losses"]))
    assert res["imgs_per_sec"] > 0 and res["ms_per_step"] > 0


def test_profile_needs_the_card():
    from bigdl_tpu_torch.tools.bench import profile_resnet50
    with pytest.raises(ValueError, match="CUDA"):
        profile_resnet50(device="cpu")


# --------------------------------------------------------------------------
# The rest of the training loop: the other methods, the schedules,
# Plateau through validation, per-submodule methods, L-BFGS, transformers
# --------------------------------------------------------------------------

#: name -> keyword settings, the same in both packages (weight decay and
#: a learning-rate decay where the method takes them)
METHODS = {
    "LAMB": dict(learning_rate=1e-2, weight_decay=1e-2),
    "Adagrad": dict(learning_rate=0.1, learning_rate_decay=0.1,
                    weight_decay=1e-3),
    "Adadelta": dict(decay_rate=0.9, epsilon=1e-6, weight_decay=1e-3),
    "Adamax": dict(learning_rate=1e-2, weight_decay=1e-3),
    "RMSprop": dict(learning_rate=1e-2, learning_rate_decay=0.1,
                    decay_rate=0.9, weight_decay=1e-3),
    "Ftrl": dict(learning_rate=0.1, l1_regularization_strength=0.01,
                 l2_regularization_strength=0.02,
                 l2_shrinkage_regularization_strength=0.01),
    "LBFGS": dict(learning_rate=0.1),
}


def _slot_leaves(state):
    """The slot tensors of a method state in key order (step counts and
    empty histories aside)."""
    leaves = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(_np, state,
                               is_leaf=lambda x: isinstance(x, torch.Tensor)))
    return [l for l in leaves if np.ndim(l) > 0]


@pytest.mark.parametrize("name", sorted(METHODS))
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_method_updates_match_jax(name, precision):
    """5 updates at the learning rate each method reports, in f32 and on
    bf16 parameters with f32 masters: parameters (the masters in bf16)
    and slots within 1e-5 of each tensor's largest element, and in bf16
    the parameters within one bf16 ulp (2**-8 relative)."""
    kw = METHODS[name]
    jm, tm = getattr(joptim, name)(**kw), getattr(toptim, name)(**kw)
    bf16 = precision == "bfloat16"
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    p0 = _tree(3)
    jp, tp = _j(p0, jdt), _t(p0, tdt)
    js, ts = jm.init_state_with_masters(jp), tm.init_state_with_masters(tp)
    key = toptim.OptimMethod._MASTER_KEY
    for step in range(5):
        g = _tree(30 + step)
        jlr, tlr = jm.current_lr(), tm.current_lr()
        assert tlr == pytest.approx(jlr, rel=1e-12)
        jp, js = jm.update_with_masters(_j(g, jdt), js, jp, jlr)
        tp, ts = tm.update_with_masters(_t(g, tdt), ts, tp, tlr)
        jm.state["neval"] += 1
        tm.state["neval"] += 1
        masters = (ts[key], js[key]) if bf16 else (tp, jp)
        for k in SHAPES:
            want = _np(masters[1][k])
            np.testing.assert_allclose(
                _np(masters[0][k]), want, rtol=0,
                atol=1e-5 * np.abs(want).max(), err_msg=f"{name} {k}")
            if bf16:
                assert tp[k].dtype == torch.bfloat16
                np.testing.assert_allclose(_np(tp[k]), _np(jp[k]),
                                           rtol=2.0 ** -8, atol=0)
        got_s, want_s = _slot_leaves(ts), _slot_leaves(js)
        assert len(got_s) == len(want_s)
        for a, b in zip(got_s, want_s):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-5 * max(np.abs(b).max(),
                                                       1e-6))


def _decay_by_two_epochs(epoch):
    return epoch // 2


def _schedules(pkg):
    seq = pkg.SequentialSchedule(3)
    seq.add(pkg.Warmup(0.01), 10).add(pkg.Poly(1.0, 20), 20)
    return {
        "Poly": pkg.Poly(0.5, 20),
        "Step": pkg.Step(7, 0.5),
        "MultiStep": pkg.MultiStep([5, 12, 20], 0.3),
        "EpochDecay": pkg.EpochDecay(_decay_by_two_epochs),
        "EpochStep": pkg.EpochStep(2, 0.5),
        "NaturalExp": pkg.NaturalExp(5, 0.3),
        "Exponential": pkg.Exponential(6, 0.8),
        "Exponential staircase": pkg.Exponential(6, 0.8, True),
        "EpochSchedule": pkg.EpochSchedule([
            pkg.Regime(1, 1, {"learningRate": 0.2}),
            pkg.Regime(2, 2, {"learningRate": 0.05, "weightDecay": 1e-4,
                              "momentum": 0.5})]),
        "Plateau (no validation)": pkg.Plateau(),
        "Warmup": pkg.Warmup(0.01),
        "SequentialSchedule": seq,
        "EpochDecayWithWarmUp": pkg.EpochDecayWithWarmUp(
            8, 0.02, _decay_by_two_epochs),
        "Default": pkg.Default(),
        "CosineDecay": pkg.CosineDecay(20, 0.1),
        "WarmupCosineDecay": pkg.WarmupCosineDecay(5, 25, 0.1),
    }


@pytest.mark.parametrize("name", sorted(_schedules(joptim)))
def test_schedule_learning_rates_match_jax(name):
    """30 iterations of 10 a epoch: the learning rate SGD reports and,
    for EpochSchedule, the settings it writes, equal the reference's."""
    jsgd = joptim.SGD(0.1, 0.01, momentum=0.9,
                      learning_rate_schedule=_schedules(joptim)[name])
    tsgd = toptim.SGD(0.1, 0.01, momentum=0.9,
                      learning_rate_schedule=_schedules(toptim)[name])
    got, want = [], []
    for n in range(30):
        for m in (jsgd, tsgd):
            m.state["neval"], m.state["epoch"] = n, n // 10
        want.append(jsgd.current_lr())
        got.append(tsgd.current_lr())
        assert (tsgd.weight_decay, tsgd.momentum) == \
            (jsgd.weight_decay, jsgd.momentum)
        assert tsgd.state["neval"] == n
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert len(set(np.round(got, 12))) > 1 or name.startswith("Plateau")


def _mlp_pair(seed=5):
    """Sequential(Linear 4->8 "enc", Tanh, Linear 8->3 "dec", LogSoftMax)
    in both packages, the JAX weights carried into the port."""
    jm = (jnn.Sequential().add(jnn.Linear(4, 8, name="enc")).add(jnn.Tanh())
          .add(jnn.Linear(8, 3, name="dec")).add(jnn.LogSoftMax()))
    tm = (tnn.Sequential()
          .add(tnn.Linear(4, 8, name="enc", device="cpu")).add(tnn.Tanh())
          .add(tnn.Linear(8, 3, name="dec", device="cpu"))
          .add(tnn.LogSoftMax()))
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(seed)))
    jm.set_params(jax.tree_util.tree_map(jnp.asarray, params))
    load_module_params(tm, params)
    return jm, tm


def _mlp_data(n=16, seed=6):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 4).astype(np.float32),
            rs.randint(1, 4, n).astype(np.int32))


def test_plateau_is_fed_by_validation_through_the_loop():
    """Validation every step on a held-out set with [Loss]: the first
    method's score goes to Plateau.record. The held-out labels are
    random, so the held-out loss rises as the training batch is fitted:
    in "min" mode it never improves after the first validation, and the
    rate is cut by `factor` every `patience` validations, in both
    packages alike; the losses follow."""
    from bigdl_tpu.dataset.dataset import LocalDataSet as JLocalDataSet
    from bigdl_tpu.dataset.sample import MiniBatch as JMiniBatch
    from bigdl_tpu.dataset.sample import Sample as JSample
    from bigdl_tpu_torch.dataset import Sample
    jm, tm = _mlp_pair()
    x, y = _mlp_data()
    vx, vy = _mlp_data(8, seed=7)
    runs = {}
    for pkg, model, ds, mb, sample in (
            (joptim, jm, JLocalDataSet, JMiniBatch, JSample),
            (toptim, tm, LocalDataSet, MiniBatch, Sample)):
        crit = (jnn if pkg is joptim else tnn).ClassNLLCriterion()
        kw = {} if pkg is joptim else {"device": "cpu"}
        opt = pkg.LocalOptimizer(model, ds([mb(x, y)]), crit, **kw)
        plateau = pkg.Plateau(factor=0.5, patience=2, mode="min")
        opt.set_optim_method(pkg.SGD(0.5, learning_rate_schedule=plateau))
        opt.set_validation(pkg.several_iteration(1),
                           [sample(a, b) for a, b in zip(vx, vy)],
                           [pkg.Loss(crit)], batch_size=8)
        opt.set_end_when(pkg.max_iteration(7))
        lrs, losses = [], []
        opt.set_iteration_hook(lambda s, p=plateau, l=lrs, o=losses: (
            l.append(p._lr), o.append(s["loss"])))
        opt.optimize()
        runs[pkg is toptim] = (lrs, losses)
    (t_lrs, t_losses), (j_lrs, j_losses) = runs[True], runs[False]
    assert t_lrs == j_lrs
    assert t_lrs[-1] == 0.5 * 0.5 ** 3
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)


@pytest.mark.parametrize("loop", ["LocalOptimizer", "DistriOptimizer"])
def test_set_optim_methods_on_a_two_child_model(loop):
    """{"enc": SGD with momentum, "dec": Adam}: each top-level child
    trains under its own method; 3 steps give the reference's losses and
    parameters (within a relative 1e-5 and 1e-5 of each tensor's
    largest element)."""
    jm, tm = _mlp_pair()
    x, y = _mlp_data()
    jopt = joptim.LocalOptimizer(jm, JLocalDataSet([JMiniBatch(x, y)]),
                                 jnn.ClassNLLCriterion())
    kw = {"device": "cpu"} if loop == "LocalOptimizer" else \
        {"devices": ["cpu"]}
    topt = getattr(toptim, loop)(tm, LocalDataSet([MiniBatch(x, y)]),
                                 tnn.ClassNLLCriterion(), **kw)
    losses = {}
    for pkg, opt in ((joptim, jopt), (toptim, topt)):
        opt.set_optim_methods({"enc": pkg.SGD(0.1, momentum=0.9),
                               "dec": pkg.Adam(0.01)})
        assert isinstance(opt.optim_method, pkg.CompositeOptimMethod)
        opt.set_end_when(pkg.max_iteration(3))
        got = losses[pkg is toptim] = []
        opt.set_iteration_hook(lambda s, g=got: g.append(s["loss"]))
        opt.optimize()
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-5)
    assert topt.optim_method.current_lr() == jopt.optim_method.current_lr()
    want = jax.tree_util.tree_map(np.asarray, jm.ensure_params())
    got = module_params_tree(tm)
    for k in want:
        for leaf in want[k]:
            np.testing.assert_allclose(
                got[k][leaf], want[k][leaf], rtol=0,
                atol=1e-5 * np.abs(want[k][leaf]).max())


def test_set_optim_methods_checks_its_children():
    _, tm = _mlp_pair()
    opt = toptim.LocalOptimizer(tm, LocalDataSet([]),
                                tnn.ClassNLLCriterion(), device="cpu")
    with pytest.raises(ValueError, match="no top-level submodule"):
        opt.set_optim_methods({"nope": toptim.SGD()})
    opt.set_optim_methods({"enc": toptim.SGD()})
    with pytest.raises(ValueError, match="no optim method"):
        opt.optim_method.init_state(dict(tm.named_parameters()))


def test_lbfgs_full_batch_on_a_quadratic():
    """0.5 x'Ax - b'x with A symmetric positive definite (5x5), from the
    same start: the port's two-loop recursion reaches the reference's
    point (within 1e-4 relative) and the minimiser A^-1 b."""
    rs = np.random.RandomState(8)
    q = rs.randn(5, 5).astype(np.float32)
    a = (q @ q.T / 5 + np.eye(5)).astype(np.float32)
    b = rs.randn(5).astype(np.float32)
    x0 = {"x": np.zeros(5, np.float32), "y": np.zeros(1, np.float32)}

    def j_lg(p):
        def f(p):
            return 0.5 * p["x"] @ (a @ p["x"]) - b @ p["x"] \
                + jnp.sum((p["y"] - 2.0) ** 2)
        return jax.value_and_grad(f)(p)

    def t_lg(p):
        p = {k: v.detach().requires_grad_() for k, v in p.items()}
        at, bt = torch.from_numpy(a), torch.from_numpy(b)
        loss = 0.5 * p["x"] @ (at @ p["x"]) - bt @ p["x"] \
            + torch.sum((p["y"] - 2.0) ** 2)
        grads = torch.autograd.grad(loss, list(p.values()))
        return loss.detach(), dict(zip(p, grads))

    kw = dict(max_iter=50, tol_fun=1e-9, learning_rate=0.5)
    want = joptim.LBFGS(**kw).optimize_full_batch(j_lg, _j(x0))
    got = toptim.LBFGS(**kw).optimize_full_batch(t_lg, _t(x0))
    for k in x0:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(_np(got["x"]), np.linalg.solve(a, b),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(_np(got["y"]), [2.0], rtol=1e-4)


def test_transformer_chains_and_padded_batches():
    """FuncTransformer >> FuncTransformer >> SampleToMiniBatch with a
    PaddingParam, and `chain` of the same stages, on ragged records: the
    reference's batches, element-wise flags and `apply_one`."""
    from bigdl_tpu.dataset import transformer as jtr
    from bigdl_tpu.dataset.sample import PaddingParam as JPaddingParam
    from bigdl_tpu.dataset.sample import Sample as JSample
    from bigdl_tpu_torch.dataset import (FuncTransformer, PaddingParam,
                                         Sample, SampleToMiniBatch, chain)
    rs = np.random.RandomState(9)
    recs = [(rs.randn(n).astype(np.float32), np.arange(1, n + 1))
            for n in (3, 5, 2, 4, 1)]

    def stages(fmod, smod, pad, sample):
        return (fmod(lambda r: (r[0] * 2, r[1])),
                fmod(lambda r: sample(r[0], r[1])),
                smod(2, pad(-1.0, 6), pad(0)))

    j = stages(jtr.FuncTransformer, jtr.SampleToMiniBatch, JPaddingParam,
               JSample)
    t = stages(FuncTransformer, SampleToMiniBatch, PaddingParam, Sample)
    want = list((j[0] >> j[1] >> j[2])(recs))
    for pipe in (t[0] >> t[1] >> t[2], chain(*t)):
        got = list(pipe(recs))
        assert [b.size() for b in got] == [b.size() for b in want] == \
            [2, 2, 1]
        for gb, wb in zip(got, want):
            np.testing.assert_array_equal(gb.get_input(), wb.get_input())
            np.testing.assert_array_equal(gb.get_target(), wb.get_target())
    assert got[0].get_input().shape == (2, 6)
    assert (t[0] >> t[1]).elementwise and not (t[1] >> t[2]).elementwise
    np.testing.assert_array_equal(t[0].apply_one(recs[0])[0],
                                  j[0].apply_one(recs[0])[0])
