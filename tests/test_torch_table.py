"""Port parity: the 1-based `Table` (`bigdl_tpu_torch.utils.table`) and the
modules that produce and consume one (`ConcatTable`, `CAddTable`,
`LocalPredictor`) against `bigdl_tpu`.

- `Table` and `T`: the same keys, order, values, lengths, `insert`,
  membership, equality and repr as the reference's for the same items;
  `t[0]` raises `KeyError` in both.
- `ConcatTable`: `out[1]`, `out[2]` and `len(out)` equal the reference's
  (carried weights, f32, within 1e-6: the same products), and `out[1]` is
  the first branch in both packages.
- `CAddTable` sums a `Table` as the reference does; `LocalPredictor` on a
  model that ends in a `ConcatTable` returns its first branch, `out[1]`,
  in both packages.
- A multi-input batch reaches the model as the 1-based `Table`: a model
  that returns `input[1]` gets the first array through `LocalOptimizer`,
  `DistriOptimizer`, `LocalPredictor`, `Evaluator` and `InferenceEngine`,
  as in the reference (losses, parameters and outputs within 1e-6: the
  same f32 arithmetic); a list target reaches the criterion as a `Table`
  too; a string column stays a numpy array on the host for a
  feature-column op.

Inputs come from numpy with fixed seeds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
import bigdl_tpu.ops as jops
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset.dataset import LocalDataSet as JLocalDataSet
from bigdl_tpu.dataset.sample import MiniBatch as JMiniBatch
from bigdl_tpu.dataset.sample import Sample as JSample
from bigdl_tpu.optim.distri_optimizer import DistriOptimizer as JDistri
from bigdl_tpu.optim.evaluator import Evaluator as JEvaluator
from bigdl_tpu.parallel.mesh import build_mesh as jbuild_mesh
from bigdl_tpu.nn.module import functional_apply
from bigdl_tpu.optim.predictor import LocalPredictor as JPredictor
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu.utils.table import Table as JTable
import bigdl_tpu_torch.nn as tnn
import bigdl_tpu_torch.ops as tops
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch, Sample
from bigdl_tpu_torch.interop import load_module_params
from bigdl_tpu_torch.optim import Evaluator, LocalPredictor
from bigdl_tpu_torch.serving import InferenceEngine
from bigdl_tpu_torch.utils import T, Table

ATOL = 1e-6


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# --------------------------------------------------------------------------
# Table and T
# --------------------------------------------------------------------------

#: (positional items, keyword items) built in both packages
CASES = {
    "positional": ((3, "a", 5.0), {}),
    "keywords": ((), {"b": 2, "a": 1}),
    "mixed": ((10, 20), {"z": 1, "y": 2}),
    "empty": ((), {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_table_semantics_match_the_reference(case):
    items, kw = CASES[case]
    j, t = JT(*items, **kw), T(*items, **kw)
    assert isinstance(t, Table)
    assert t.keys() == j.keys()
    assert t.values() == j.values() == list(t) == list(j)
    assert len(t) == len(j)
    assert repr(t) == repr(j)
    for k in j.keys():
        assert k in t and t[k] == j[k]
    assert (0 in t) == (0 in j) is False
    with pytest.raises(KeyError):
        t[0]
    with pytest.raises(KeyError):
        j[0]
    j.insert("new")
    t.insert("new")
    assert t.keys() == j.keys() and t.values() == j.values()
    t["k"] = j["k"] = 7
    assert t.keys() == j.keys()


def test_table_keys_sort_integers_numerically_then_strings():
    t, j = Table(), JTable()
    for k in (10, "b", 2, "a", 1):
        t[k] = j[k] = str(k)
    assert t.keys() == j.keys() == [1, 2, 10, "a", "b"]


def test_table_equality_compares_tensors_by_value():
    a = T(torch.arange(3.0), T(1, "x"), name=np.ones(2))
    b = T(torch.arange(3.0), T(1, "x"), name=np.ones(2))
    assert a == b
    assert a != T(torch.arange(3.0) + 1, T(1, "x"), name=np.ones(2))
    assert a != T(torch.arange(3.0), T(1, "y"), name=np.ones(2))
    assert a != T(torch.arange(3.0), T(1, "x"))
    assert T(torch.ones(2)) != T(np.ones(2))
    # the reference's, on the same values
    ja = JT(jnp.arange(3.0), JT(1, "x"), name=np.ones(2))
    assert ja == JT(jnp.arange(3.0), JT(1, "x"), name=np.ones(2))
    assert ja != JT(jnp.arange(3.0) + 1, JT(1, "x"), name=np.ones(2))


# --------------------------------------------------------------------------
# ConcatTable, CAddTable, LocalPredictor
# --------------------------------------------------------------------------

def _concat_pair():
    j = jnn.ConcatTable().add(jnn.Linear(4, 2)).add(jnn.Linear(4, 3))
    t = (tnn.ConcatTable().add(tnn.Linear(4, 2, device="cpu"))
         .add(tnn.Linear(4, 3, device="cpu")))
    params = jax.tree_util.tree_map(np.asarray,
                                    j.init(jax.random.PRNGKey(1)))
    load_module_params(t, params)
    return j, t, params


def test_concat_table_is_one_based_in_both_packages():
    j, t, params = _concat_pair()
    x = _x(5, 4)
    out_j, _ = functional_apply(j, params, jnp.asarray(x))
    out_t = t(torch.from_numpy(x))
    assert isinstance(out_t, Table) and isinstance(out_j, JTable)
    assert len(out_t) == len(out_j) == 2
    assert out_t.keys() == out_j.keys() == [1, 2]
    # out[1] is the first branch (2 outputs), out[2] the second (3)
    assert tuple(out_t[1].shape) == tuple(out_j[1].shape) == (5, 2)
    assert tuple(out_t[2].shape) == tuple(out_j[2].shape) == (5, 3)
    for k in (1, 2):
        np.testing.assert_allclose(out_t[k].detach().numpy(),
                                   np.asarray(out_j[k]), atol=ATOL, rtol=0)
    with pytest.raises(KeyError):
        out_t[0]


def test_cadd_table_sums_a_table():
    x = _x(3, 4, seed=1)
    want = np.asarray(jnn.CAddTable().forward(
        JT(jnp.asarray(x), jnp.asarray(2 * x), jnp.asarray(-x))))
    got = tnn.CAddTable()(T(torch.from_numpy(x), torch.from_numpy(2 * x),
                            torch.from_numpy(-x)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # a ConcatTable into a CAddTable: the residual block's join
    j, t, params = _concat_pair()
    j2 = jnn.ConcatTable().add(jnn.Linear(4, 3)).add(jnn.Linear(4, 3))
    t2 = (tnn.ConcatTable().add(tnn.Linear(4, 3, device="cpu"))
          .add(tnn.Linear(4, 3, device="cpu")))
    p2 = jax.tree_util.tree_map(np.asarray, j2.init(jax.random.PRNGKey(2)))
    load_module_params(t2, p2)
    jm = jnn.Sequential().add(j2).add(jnn.CAddTable())
    tm = tnn.Sequential().add(t2).add(tnn.CAddTable())
    out_j, _ = functional_apply(jm, {"0_ConcatTable": p2, "1_CAddTable": {}},
                                jnp.asarray(x))
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(out_j), atol=ATOL, rtol=0)


def test_local_predictor_gives_the_first_branch():
    """A model that ends in a ConcatTable predicts its first branch,
    `out[1]`, in both packages."""
    jm = (jnn.Sequential().add(jnn.Linear(6, 8))
          .add(jnn.ConcatTable().add(jnn.Linear(8, 3))
               .add(jnn.Linear(8, 2))))
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(3)))
    jm.set_params(jax.tree_util.tree_map(jnp.asarray, params))
    tm = (tnn.Sequential().add(tnn.Linear(6, 8, device="cpu"))
          .add(tnn.ConcatTable().add(tnn.Linear(8, 3, device="cpu"))
               .add(tnn.Linear(8, 2, device="cpu"))))
    load_module_params(tm, params)
    x = _x(5, 6, seed=4)
    want = JPredictor(jm, batch_size=4).predict([JSample(r) for r in x])
    got = LocalPredictor(tm, batch_size=4, device="cpu").predict(
        [Sample(r) for r in x])
    assert got[0].shape == want[0].shape == (3,)
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=ATOL,
                               rtol=0)


# --------------------------------------------------------------------------
# Multi-input batches reach the model as the 1-based Table
# --------------------------------------------------------------------------

class JFirst(jnn.Module):
    """The reference side: `input[1] * scale`."""

    def init(self, rng):
        return {"scale": jnp.asarray([1.0, 0.5, 2.0], jnp.float32)}

    def apply(self, params, input, ctx):
        return input[1] * params["scale"]


class TFirst(tnn.Module):
    """The port side: `input[1] * scale`."""

    def __init__(self):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.tensor([1.0, 0.5, 2.0]))

    def forward(self, input):
        return input[1] * self.scale


def _two_inputs(n=8):
    """The first array near 0, the second near 10: a model that reads the
    wrong one is off by ~10."""
    return _x(n, 3, seed=20), _x(n, 3, seed=21) + 10.0, _x(n, 3, seed=22)


def _jax_first():
    jm = JFirst()
    jm.ensure_params()
    return jm


def _train_both(port_kind):
    a, b, y = _two_inputs()
    jm = _jax_first()
    jds = JLocalDataSet([JMiniBatch([a, b], y)])
    if port_kind == "local":
        jopt = joptim.LocalOptimizer(jm, jds, jnn.MSECriterion())
    else:
        jopt = JDistri(jm, jds, jnn.MSECriterion(),
                       mesh=jbuild_mesh(data=1, devices=jax.devices()[:1]))
    tm = TFirst()
    tds = LocalDataSet([MiniBatch([a, b], y)])
    if port_kind == "local":
        topt = toptim.LocalOptimizer(tm, tds, tnn.MSECriterion(),
                                     device="cpu")
    else:
        topt = toptim.DistriOptimizer(tm, tds, tnn.MSECriterion(),
                                      devices=["cpu"])
    runs = []
    for opt, pkg in ((jopt, joptim), (topt, toptim)):
        opt.set_optim_method(pkg.SGD(learning_rate=0.1, momentum=0.9))
        opt.set_end_when(pkg.max_iteration(3))
        losses = []
        opt.set_iteration_hook(lambda s, losses=losses: losses.append(
            s["loss"]))
        opt.optimize()
        runs.append(losses)
    return runs, np.asarray(jm.ensure_params()["scale"]), \
        tm.scale.detach().numpy()


@pytest.mark.parametrize("kind", ["local", "distri"])
def test_optimizers_give_the_model_a_one_based_table(kind):
    (j_losses, t_losses), j_scale, t_scale = _train_both(kind)
    assert len(t_losses) == 3
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-6)
    np.testing.assert_allclose(t_scale, j_scale, rtol=1e-6, atol=ATOL)


def test_a_list_target_reaches_the_criterion_as_a_table():
    """The reference's loop gives a list target as a `Table` too: a
    criterion that reads `target[1]` trains as the reference's does on
    the first target alone."""
    a, b, y = _two_inputs()
    jm = _jax_first()
    jopt = joptim.LocalOptimizer(jm, JLocalDataSet([JMiniBatch([a, b], y)]),
                                 jnn.MSECriterion())
    tm = TFirst()
    seen = []

    def first_target_mse(out, t):
        seen.append(type(t))
        return torch.mean((out - t[1]) ** 2)

    topt = toptim.LocalOptimizer(
        tm, LocalDataSet([MiniBatch([a, b], [y, y + 100.0])]),
        first_target_mse, device="cpu")
    runs = []
    for opt, pkg in ((jopt, joptim), (topt, toptim)):
        opt.set_optim_method(pkg.SGD(learning_rate=0.1))
        opt.set_end_when(pkg.max_iteration(2))
        losses = []
        opt.set_iteration_hook(lambda s, losses=losses: losses.append(
            s["loss"]))
        opt.optimize()
        runs.append(losses)
    assert seen and all(t is Table for t in seen)
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-6)


def _samples_both(n=8):
    a, b, y = _two_inputs(n)
    return ([JSample([a[i], b[i]], y[i]) for i in range(n)],
            [Sample([a[i], b[i]], y[i]) for i in range(n)])


def test_local_predictor_gives_the_model_a_one_based_table():
    jm = _jax_first()
    js, ts = _samples_both()
    want = JPredictor(jm, batch_size=3).predict(js)
    got = LocalPredictor(TFirst(), batch_size=3, device="cpu").predict(ts)
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=ATOL,
                               rtol=0)


def test_evaluator_gives_the_model_a_one_based_table():
    from bigdl_tpu.optim.validation import Loss as JLoss
    from bigdl_tpu_torch.optim.validation import Loss
    jm = _jax_first()
    js, ts = _samples_both()
    (want,) = JEvaluator(jm, 4).test(js, [JLoss(jnn.MSECriterion())])
    (got,) = Evaluator(TFirst(), 4, device="cpu").test(
        ts, [Loss(tnn.MSECriterion())])
    np.testing.assert_allclose(got.result()[0], want.result()[0], rtol=1e-6)
    assert got.result()[1] == want.result()[1]


def test_inference_engine_gives_the_model_a_one_based_table():
    jm = _jax_first()
    js, ts = _samples_both(5)
    want = JPredictor(jm, batch_size=5).predict(js)
    with InferenceEngine(TFirst(), max_batch_size=8, max_wait_ms=25.0,
                         device="cpu", start=False) as eng:
        futs = [eng.submit(s) for s in ts]
        eng.start()
        got = [f.result(60) for f in futs]
        assert eng.stats()["batches"] == 1
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=ATOL,
                               rtol=0)


class THashed(tnn.Module):
    """`input[1] * scale` plus the crc32 bucket of the string column
    `input[2]`, hashed on the host."""

    def __init__(self):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.ones(3))
        self.hash = tops.CategoricalColHashBucket(5, device="cpu")

    def forward(self, input):
        assert isinstance(input[2], np.ndarray) and input[2].dtype.kind == "U"
        return input[1] * self.scale + self.hash(input[2]).float()[:, None]


def test_a_string_column_reaches_a_feature_column_op_on_the_host():
    a, _, y = _two_inputs()
    words = np.array(["cat", "dog", "emu", "yak", "cat", "owl", "dog", "ant"])
    buckets = np.asarray(jops.CategoricalColHashBucket(5).forward(words))
    want = a + buckets[:, None].astype(np.float32)
    got = LocalPredictor(THashed(), batch_size=3, device="cpu",
                         convert=False).predict(
        [Sample([a[i], words[i]]) for i in range(8)])
    np.testing.assert_allclose(np.stack(got), want, atol=ATOL, rtol=0)
    tm = THashed()
    opt = toptim.LocalOptimizer(tm, LocalDataSet([MiniBatch([a, words], y)]),
                                tnn.MSECriterion(), device="cpu")
    opt.set_optim_method(toptim.SGD(learning_rate=0.01))
    opt.set_end_when(toptim.max_iteration(1))
    losses = []
    opt.set_iteration_hook(lambda s: losses.append(s["loss"]))
    opt.optimize()
    np.testing.assert_allclose(losses[0], np.mean((want - y) ** 2),
                               rtol=1e-6)
