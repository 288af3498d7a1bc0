"""Port parity: `bigdl_tpu_torch.optim.validation` and `Evaluator` against
`bigdl_tpu.optim`.

Every validation method on the same seeded outputs and targets (numpy),
through both packages: accuracy counts equal exactly, losses within a
relative 1e-6 (the same f32 operations, summed in another order). Results
merged with `+` against the reference's. `Evaluator.test` on a CIFAR
ResNet-8 carrying the JAX weights and BN state against the reference's
`Evaluator` over 3 batches (one ragged): the counts equal (the random
weights leave no top-2 margin under 1e-3 on these inputs, checked), the
loss within a relative 1e-5 (f32 convolutions summed in other orders
through 8 layers).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset.sample import Sample as JSample
from bigdl_tpu.models.resnet import ResNet as JResNet
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import Sample
from bigdl_tpu_torch.interop import load_module_params
from bigdl_tpu_torch.models import ResNet as TResNet

N, C = 37, 10


def _logp(seed, n=N, c=C):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, c).astype(np.float32)
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


def _labels(seed, n=N, c=C, base=1):
    return (np.random.RandomState(seed).randint(0, c, n) + base).astype(
        np.int32)


def _cases():
    rs = np.random.RandomState(5)
    groups = rs.randn(6, 11).astype(np.float32)
    hits = np.zeros((6, 11), np.float32)
    hits[np.arange(6), rs.randint(0, 11, 6)] = 1.0
    tree_out = rs.randn(5, 3, C).astype(np.float32)
    tree_t = (rs.randint(0, C, (5, 3)) + 1).astype(np.int32)
    onehot = np.eye(C, dtype=np.float32)[_labels(2, base=0)]
    return {
        "top1": ("Top1Accuracy", (), _logp(0), _labels(1)),
        "top1 zero_based": ("Top1Accuracy", (True,), _logp(0),
                            _labels(1, base=0)),
        "top1 binary": ("Top1Accuracy", (), rs.rand(N, 1).astype(
            np.float32), rs.randint(0, 2, N).astype(np.float32)),
        "top1 one-hot": ("Top1Accuracy", (), _logp(3), onehot),
        "top5": ("Top5Accuracy", (), _logp(4), _labels(6)),
        "top5 zero_based": ("Top5Accuracy", (True,), _logp(4),
                            _labels(6, base=0)),
        "loss": ("Loss", (), _logp(7), _labels(8)),
        "mae": ("MAE", (), _logp(9), _labels(10).astype(np.float32)),
        "hit ratio": ("HitRatio", (3, 10), groups, hits),
        "hit ratio column 0": ("HitRatio", (3, 10), groups, None),
        "ndcg": ("NDCG", (4, 10), groups, hits),
        "ndcg column 0": ("NDCG", (4, 10), groups, None),
        "tree": ("TreeNNAccuracy", (), tree_out, tree_t),
        "tree 1-d target": ("TreeNNAccuracy", (), tree_out, tree_t[:, 0]),
    }


CASES = _cases()


def _pair(name, args):
    return getattr(toptim, name)(*args), getattr(joptim, name)(*args)


def _check(got, want):
    assert type(got).__name__ == type(want).__name__
    (g, gn), (w, wn) = got.result(), want.result()
    assert gn == wn
    np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_method_matches_the_reference(case):
    name, args, out, target = CASES[case]
    tm, jm = _pair(name, args)
    t_t = None if target is None else torch.from_numpy(target)
    j_t = None if target is None else jnp.asarray(target)
    _check(tm.apply(torch.from_numpy(out), t_t),
           jm.apply(jnp.asarray(out), j_t))
    assert repr(tm) == repr(jm)


@pytest.mark.parametrize("case", ["top1", "top5", "loss", "ndcg"])
def test_results_merge_as_the_reference(case):
    name, args, out, target = CASES[case]
    tm, jm = _pair(name, args)
    halves = [slice(0, 12), slice(12, None)]
    got = [tm.apply(torch.from_numpy(out[s]), torch.from_numpy(target[s]))
           for s in halves]
    want = [jm.apply(jnp.asarray(out[s]), jnp.asarray(target[s]))
            for s in halves]
    _check(got[0] + got[1], want[0] + want[1])
    _check(got[0] + got[1], tm.apply(torch.from_numpy(out),
                                     torch.from_numpy(target)))


def test_contiguous_result_sums():
    r = toptim.validation.ContiguousResult(3.0, 2) + \
        toptim.validation.ContiguousResult(1.0, 2)
    assert r.result() == (1.0, 4)


# --------------------------------------------------------------------------
# Evaluator on a small ResNet
# --------------------------------------------------------------------------

def _randomize_state(state, seed):
    rs = np.random.RandomState(seed)
    return {path: {"mean": rs.randn(*v["mean"].shape).astype(np.float32)
                   * 0.1,
                   "var": rs.rand(*v["var"].shape).astype(np.float32)
                   + 0.5}
            for path, v in state.items()}


def _evaluator_inputs():
    jm = JResNet(10, depth=8, data_set="cifar10")
    params = jax.tree_util.tree_map(np.asarray, jm.ensure_params())
    state = _randomize_state(jax.tree_util.tree_map(np.asarray, jm._state),
                             3)
    jm._state = jax.tree_util.tree_map(jnp.asarray, state)
    rs = np.random.RandomState(11)
    x = rs.rand(20, 16, 16, 3).astype(np.float32)
    y = (rs.randint(0, 10, 20) + 1).astype(np.int32)
    return jm, params, state, x, y


class _HostOnlyTop1(toptim.Top1Accuracy):
    """A user method that overrides only `apply`: the Evaluator must take
    the host path for it."""

    def apply(self, output, target):
        return super().apply(output, target)


def test_evaluator_matches_the_reference():
    jm, params, state, x, y = _evaluator_inputs()
    tm = TResNet(10, depth=8, data_set="cifar10", device="cpu")
    load_module_params(tm, params, state)
    j_samples = [JSample(x[i], y[i]) for i in range(len(x))]
    t_samples = [Sample(x[i], y[i]) for i in range(len(x))]
    want = joptim.Evaluator(jm, 8).test(
        j_samples, [joptim.Top1Accuracy(), joptim.Top5Accuracy(),
                    joptim.Loss()])
    got = toptim.Evaluator(tm, 8, device="cpu").test(
        t_samples, [toptim.Top1Accuracy(), toptim.Top5Accuracy(),
                    toptim.Loss(), _HostOnlyTop1()])
    # no row of these inputs sits within 1e-3 of a tie between its top two
    with torch.no_grad():
        out = tm.eval()(torch.from_numpy(x)).numpy()
    top2 = np.sort(out, -1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-3
    for g, w in zip(got[:2], want[:2]):
        assert g.result() == w.result()
    assert got[2].result()[1] == want[2].result()[1] == 20
    np.testing.assert_allclose(got[2].result()[0], want[2].result()[0],
                               rtol=1e-5)
    assert got[3].result() == got[0].result()
    assert toptim.LocalValidator is toptim.DistriValidator is \
        toptim.Evaluator
