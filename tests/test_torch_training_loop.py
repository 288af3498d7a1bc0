"""Port parity: the training loop's gradient clipping, gradient
accumulation, regularizers, triggers and validation against `bigdl_tpu`.

5-step trajectories of the CIFAR ResNet-8 (carried JAX weights and BN
state, one resident batch of 8, SGD with momentum) through the port's
`DistriOptimizer` and the reference's `DistriOptimizer` on a one-device
mesh: constant clipping, L2-norm clipping (a norm small enough to clip at
every step), both, and accumulation over 2 and 4 micro-batches (each with
its own BN batch statistics and running-stat update). Losses and the
final BN running stats within a relative 1e-4, the f32 training tolerance
of `tests/test_torch_optim.py` (convolutions summed in other orders,
carried through 5 momentum steps).

The regularizers: `grad_update` and `loss` on seeded parameters and
gradients within a relative 1e-6, and a 5-step SGD trajectory of a linear
softmax model whose gradient each package regularizes, within 1e-5.

The triggers `max_score`, `min_loss`, `and_`, `or_` against the
reference's on the same states; the validation trigger, its results and
`loop_state["score"]` against the reference's `LocalOptimizer`.

The step generator (the optimizer's `torch.Generator`, lent to every
`Dropout` for each step): `VggForCifar10` with dropout on, b4 at 32x32,
through `DistriOptimizer` with a `train.step` fault at the 6th step and
a checkpoint every 3: the retried steps draw the unfaulted run's masks,
so the losses after the recovery and the final model equal the unfaulted
run's bit for bit. Resume as the reference does it: the key chain is not
in the checkpoint, so a fresh optimizer that resumes starts it from its
seed.
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
from bigdl_tpu.dataset.sample import Sample as JSample
from bigdl_tpu.models.resnet import ResNet as JResNet
from bigdl_tpu.parallel.mesh import build_mesh
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch, Sample
from bigdl_tpu_torch.interop import load_module_params, module_state
from bigdl_tpu_torch.models import ResNet as TResNet
from bigdl_tpu_torch.models import VggForCifar10
from bigdl_tpu_torch.resilience import FaultInjector, FaultSpec, RetryPolicy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: this file runs JAX beside torch, and under the
    suite's parallel workers torch's intra-op pool and JAX's threads
    oversubscribe the cores (see tests/test_torch_recurrent.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)

STEPS, BATCH = 5, 8


def _batch():
    rs = np.random.RandomState(21)
    x = rs.rand(BATCH, 16, 16, 3).astype(np.float32)
    y = (rs.randint(0, 10, size=BATCH) + 1).astype(np.int32)
    return x, y


def _configure(opt, optim, setup):
    opt.set_optim_method(optim.SGD(learning_rate=0.05, momentum=0.9))
    opt.set_end_when(optim.max_iteration(STEPS))
    if "const" in setup:
        opt.set_constant_gradient_clipping(-0.02, 0.02)
    if "l2" in setup:
        opt.set_gradient_clipping_by_l2_norm(0.5)
    if "accum" in setup:
        opt.set_gradient_accumulation(setup["accum"])
    losses = []
    opt.set_iteration_hook(lambda s: losses.append(s["loss"]))
    return losses


def _reference(setup):
    jm = JResNet(10, depth=8, data_set="cifar10")
    params0 = jax.tree_util.tree_map(np.asarray, jm.ensure_params())
    state0 = jax.tree_util.tree_map(np.asarray, jm._state)
    x, y = _batch()
    opt = joptim.DistriOptimizer(jm, JLocalDataSet([JMiniBatch(x, y)]),
                                 jnn.ClassNLLCriterion(),
                                 mesh=build_mesh(devices=jax.devices()[:1]))
    losses = _configure(opt, joptim, setup)
    opt.optimize()
    return losses, jax.tree_util.tree_map(np.asarray, jm._state), params0, \
        state0


def _port(setup, params0, state0):
    tm = TResNet(10, depth=8, data_set="cifar10", device="cpu")
    load_module_params(tm, params0, state0)
    x, y = _batch()
    opt = toptim.DistriOptimizer(tm, LocalDataSet([MiniBatch(x, y)]),
                                 tnn.ClassNLLCriterion(), devices=["cpu"])
    losses = _configure(opt, toptim, setup)
    opt.optimize()
    return losses, module_state(tm)


SETUPS = {"constant clipping": {"const": True},
          "L2-norm clipping": {"l2": True},
          "both clippings": {"const": True, "l2": True},
          "accumulation 2": {"accum": 2},
          "accumulation 4 with clipping": {"accum": 4, "l2": True}}


@pytest.mark.parametrize("name", list(SETUPS))
def test_trajectory_matches_the_reference(name):
    setup = SETUPS[name]
    j_losses, j_state, params0, state0 = _reference(setup)
    t_losses, t_state = _port(setup, params0, state0)
    assert len(t_losses) == len(j_losses) == STEPS
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    for path in j_state:
        for k in ("mean", "var"):
            want = j_state[path][k]
            np.testing.assert_allclose(
                t_state[path][k], want, rtol=0,
                atol=1e-4 * max(np.abs(want).max(), 1e-6),
                err_msg=f"{path} {k}")


def test_clipping_changes_the_run_and_can_be_disabled():
    _, _, params0, state0 = _reference({})
    plain, _ = _port({}, params0, state0)
    clipped, _ = _port({"l2": True}, params0, state0)
    assert plain[0] == clipped[0] and plain[-1] != clipped[-1]
    tm = TResNet(10, depth=8, data_set="cifar10", device="cpu")
    opt = toptim.LocalOptimizer(tm, LocalDataSet([]),
                                tnn.ClassNLLCriterion(), device="cpu")
    opt.set_gradient_clipping_by_l2_norm(1.0).setConstantGradientClipping(
        -1, 1).disable_gradient_clipping()
    assert opt.grad_clip_norm is None and opt.grad_clip_const is None


def test_accumulation_needs_a_divisible_batch():
    _, _, params0, state0 = _reference({})
    with pytest.raises(ValueError, match="divisible"):
        _port({"accum": 3}, params0, state0)
    with pytest.raises(ValueError):
        toptim.LocalOptimizer(TResNet(10, depth=8, data_set="cifar10",
                                      device="cpu"), LocalDataSet([]),
                              tnn.ClassNLLCriterion(),
                              device="cpu").set_gradient_accumulation(0)


def test_camel_case_aliases():
    from bigdl_tpu.optim.local_optimizer import BaseOptimizer as JBase
    for name in ("setOptimMethod", "setEndWhen", "setCheckpoint",
                 "setValidation", "setGradientClippingByl2Norm",
                 "setConstantGradientClipping"):
        target = getattr(JBase, name).__name__
        assert getattr(toptim.BaseOptimizer, name) is getattr(
            toptim.BaseOptimizer, target)
    assert toptim.trigger.maxScore is toptim.max_score
    assert toptim.trigger.minLoss is toptim.min_loss


# --------------------------------------------------------------------------
# Regularizers
# --------------------------------------------------------------------------

REGS = {"l1": ("L1Regularizer", (0.01,)), "l2": ("L2Regularizer", (0.02,)),
        "l1l2": ("L1L2Regularizer", (0.01, 0.03)),
        "none": ("Regularizer", ())}


@pytest.mark.parametrize("name", list(REGS))
def test_regularizer_matches_the_reference(name):
    cls, args = REGS[name]
    t, j = getattr(toptim, cls)(*args), getattr(joptim, cls)(*args)
    rs = np.random.RandomState(4)
    p, g = rs.randn(5, 7).astype(np.float32), rs.randn(5, 7).astype(
        np.float32)
    np.testing.assert_allclose(
        t.grad_update(torch.from_numpy(p), torch.from_numpy(g)).numpy(),
        np.asarray(j.grad_update(jnp.asarray(p), jnp.asarray(g))),
        rtol=1e-6)
    np.testing.assert_allclose(float(t.loss(torch.from_numpy(p))),
                               float(j.loss(jnp.asarray(p))), rtol=1e-6)


@pytest.mark.parametrize("name", ["l1", "l2", "l1l2"])
def test_regularized_sgd_trajectory_matches_the_reference(name):
    cls, args = REGS[name]
    t_reg, j_reg = getattr(toptim, cls)(*args), getattr(joptim, cls)(*args)
    rs = np.random.RandomState(8)
    w0 = rs.randn(6, 4).astype(np.float32)
    x = rs.randn(16, 6).astype(np.float32)
    y = rs.randint(0, 4, 16)

    def j_loss(w):
        logp = jax.nn.log_softmax(jnp.asarray(x) @ w)
        return -jnp.mean(logp[jnp.arange(16), y])

    jw, tw = jnp.asarray(w0), torch.from_numpy(w0.copy())
    for _ in range(5):
        jw = jw - 0.5 * j_reg.grad_update(jw, jax.grad(j_loss)(jw))
        tw.requires_grad_(True)
        loss = -torch.log_softmax(torch.from_numpy(x) @ tw, -1)[
            torch.arange(16), torch.from_numpy(y)].mean()
        (g,) = torch.autograd.grad(loss, tw)
        with torch.no_grad():
            tw = tw - 0.5 * t_reg.grad_update(tw, g)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                                   atol=1e-6)


# --------------------------------------------------------------------------
# Triggers and validation
# --------------------------------------------------------------------------

STATES = [{"neval": n, "epoch": n // 3, "loss": 3.0 - 0.4 * n,
           "score": 0.1 * n} for n in range(8)]


@pytest.mark.parametrize("build", [
    lambda m: m.max_score(0.35), lambda m: m.min_loss(1.5),
    lambda m: m.and_(m.max_score(0.2), m.min_loss(2.0)),
    lambda m: m.or_(m.max_iteration(6), m.max_score(0.45)),
    lambda m: m.and_(m.several_iteration(2), m.or_(m.min_loss(1.0),
                                                   m.max_epoch(1)))])
def test_triggers_match_the_reference(build):
    t, j = build(toptim), build(joptim)
    assert [t(s) for s in STATES] == [j(s) for s in STATES]


def test_missing_score_and_loss_do_not_fire():
    assert not toptim.max_score(0.0)({"neval": 1})
    assert not toptim.min_loss(10.0)({"neval": 1})


def _validation_run(pkg, model, make_samples):
    x, y = _batch()
    rs = np.random.RandomState(30)
    vx = rs.rand(12, 16, 16, 3).astype(np.float32)
    vy = (rs.randint(0, 10, 12) + 1).astype(np.int32)
    if pkg is toptim:
        opt = toptim.LocalOptimizer(model, LocalDataSet([MiniBatch(x, y)]),
                                    tnn.ClassNLLCriterion(), device="cpu")
    else:
        opt = joptim.LocalOptimizer(model, JLocalDataSet([JMiniBatch(x, y)]),
                                    jnn.ClassNLLCriterion())
    opt.set_optim_method(pkg.SGD(learning_rate=0.05, momentum=0.9))
    opt.set_validation(pkg.several_iteration(2),
                       [make_samples(vx[i], vy[i]) for i in range(12)],
                       [pkg.Top1Accuracy(), pkg.Top5Accuracy(), pkg.Loss()],
                       5)
    opt.set_end_when(pkg.or_(pkg.max_iteration(6), pkg.max_score(2.0)))
    scores = []
    opt.set_iteration_hook(lambda s: scores.append(s.get("score")))
    opt.optimize()
    return scores, opt.optim_method.state


def test_validation_sets_the_score_as_the_reference():
    jm = JResNet(10, depth=8, data_set="cifar10")
    params0 = jax.tree_util.tree_map(np.asarray, jm.ensure_params())
    state0 = jax.tree_util.tree_map(np.asarray, jm._state)
    tm = TResNet(10, depth=8, data_set="cifar10", device="cpu")
    load_module_params(tm, params0, state0)
    j_scores, j_state = _validation_run(joptim, jm, JSample)
    t_scores, t_state = _validation_run(toptim, tm, Sample)
    assert t_scores[0] is None and t_scores[1] is not None
    assert t_scores == j_scores
    assert t_state["neval"] == j_state["neval"] == 6
    assert tm.training  # validation leaves the model in training mode


# ---------------------------------------------------------------- dropout

def _dropout_opt(path, seed=None, local=False):
    """VggForCifar10 (dropout on) at b4, 32x32, for 8 steps with a
    checkpoint every 3 (DistriOptimizer) or none (LocalOptimizer); the
    step generator re-seeded with `seed`."""
    rs = np.random.RandomState(31)
    x = rs.rand(4, 32, 32, 3).astype(np.float32)
    y = (rs.randint(0, 10, 4) + 1).astype(np.int32)
    model = VggForCifar10(10, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    data = LocalDataSet([MiniBatch(x, y)])
    if local:
        opt = toptim.LocalOptimizer(model, data, tnn.ClassNLLCriterion(),
                                    device="cpu")
    else:
        opt = toptim.DistriOptimizer(
            model, data, tnn.ClassNLLCriterion(),
            retry_policy=RetryPolicy(max_retries=2, base_delay_s=0.0,
                                     seed=0), devices=["cpu"])
        opt.set_checkpoint(path, toptim.several_iteration(3), keep_last_n=1)
    opt.set_optim_method(toptim.SGD(learning_rate=0.01, momentum=0.9))
    opt.set_end_when(toptim.max_iteration(8))
    if seed is not None:
        opt.generator.manual_seed(seed)
    losses = []
    opt.set_iteration_hook(lambda s: losses.append((s["neval"], s["loss"])))
    return model, opt, losses


def _dropout_run(path, fault=None, seed=None):
    model, opt, losses = _dropout_opt(path, seed)
    if fault is None:
        opt.optimize()
    else:
        with FaultInjector(fault):
            opt.optimize()
    return model, opt, losses


def test_a_retried_step_draws_the_unfaulted_runs_dropout_masks():
    model, opt, clean = _dropout_run("memory://zoo-dropout/clean")
    twin, topt, faulted = _dropout_run("memory://zoo-dropout/faulted",
                                       FaultSpec("train.step", at_hit=6))
    # steps 1-5, then the retry resumes at iter3: steps 4-8 again
    assert [n for n, _ in faulted] == [1, 2, 3, 4, 5] + list(range(4, 9))
    assert faulted[5:] == clean[3:]
    for a, b in zip(model.state_dict().values(), twin.state_dict().values()):
        assert torch.equal(a, b)
    assert torch.equal(opt.generator.get_state(), topt.generator.get_state())


def test_dropout_masks_come_from_the_step_generator():
    """The same seed trains the same; another seed draws other masks from
    the first step on; the steps' draws advance the generator."""
    _, opt, losses = _dropout_run("memory://zoo-dropout/a")
    assert _dropout_run("memory://zoo-dropout/b")[2] == losses
    assert _dropout_run("memory://zoo-dropout/c", seed=1)[2][0] \
        != losses[0]
    assert not torch.equal(opt.generator.get_state(),
                           torch.Generator().manual_seed(0).get_state())


@pytest.mark.parametrize("local", [False, True],
                         ids=["DistriOptimizer", "LocalOptimizer"])
def test_a_failed_run_puts_the_step_generator_back(local):
    """As the reference keeps its key when a run fails."""
    _, opt, _ = _dropout_opt("memory://zoo-dropout/failed", seed=1,
                             local=local)
    with FaultInjector(FaultSpec("train.step", at_hit=3,
                                 exc=ValueError("permanent"))):
        with pytest.raises(ValueError):
            opt.optimize()
    assert torch.equal(opt.generator.get_state(),
                       torch.Generator().manual_seed(1).get_state())


def test_resume_in_a_fresh_optimizer_starts_the_chain_from_its_seed():
    """As the reference: the checkpoint holds no key chain, so a fresh
    optimizer resumed from it draws from its seed again; the optimizer
    that wrote the checkpoint takes the state it committed with it."""
    path = "memory://zoo-dropout/resume"
    _, opt, _ = _dropout_run(path)
    _, fresh, _ = _dropout_opt(path)
    assert fresh.resume_from_latest_checkpoint()
    assert fresh.optim_method.state["neval"] == 6
    assert torch.equal(fresh.generator.get_state(),
                       torch.Generator().manual_seed(0).get_state())
    committed = opt._generator_commits[6]
    opt.generator.manual_seed(5)
    assert opt.resume_from_latest_checkpoint()
    assert torch.equal(opt.generator.get_state(), committed)
