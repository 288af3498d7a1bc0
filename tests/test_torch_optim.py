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
  differences on.
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
from bigdl_tpu_torch.interop import load_module_params, module_state
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
    tm = TResNet(10, depth=8, data_set="cifar10", device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        toptim.DistriOptimizer(tm, LocalDataSet([]),
                               tnn.ClassNLLCriterion(),
                               devices=["cpu", "cpu"])


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
