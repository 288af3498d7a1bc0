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

Inputs come from numpy with fixed seeds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset.sample import Sample as JSample
from bigdl_tpu.nn.module import functional_apply
from bigdl_tpu.optim.predictor import LocalPredictor as JPredictor
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu.utils.table import Table as JTable
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.dataset import Sample
from bigdl_tpu_torch.interop import load_module_params
from bigdl_tpu_torch.optim import LocalPredictor
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
