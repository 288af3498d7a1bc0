"""Port parity: the table containers of `nn/containers.py` against
`bigdl_tpu`'s, one parametrised case each.

`ParallelTable`, `MapTable` and `Bottle` (over `Linear` children, their
weights carried to the JAX twin), `CSubTable`, `CMulTable`, `CDivTable`,
`CMaxTable`, `CMinTable`, `CAveTable`, `JoinTable`, `SplitTable`,
`FlattenTable`, `SelectTable` (1-based and from the end), `NarrowTable`,
`MixtureTable` (a `Table` of experts and one stacked tensor),
`BifurcateSplitTable` and `Echo` (its printed line too): on the same
seeded numpy inputs, every output and the gradient of `sum(out * w)` with
respect to every float input and parameter. JAX runs in f32 at
"highest" precision (tests/conftest.py). Tolerances: outputs rtol 1e-5 /
atol 1e-6, gradients rtol 1e-4 / atol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
from bigdl_tpu.nn.module import functional_apply as jfunctional_apply
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu.utils.table import Table as JTable
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.interop import module_params_tree
from bigdl_tpu_torch.utils import T, Table

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: this file runs JAX beside torch (see
    tests/test_torch_recurrent.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _a(*shape, seed=0, positive=False):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    return np.abs(x) + 0.5 if positive else x


PAIR = ("table", _a(3, 4, seed=1), _a(3, 4, seed=2))
TRIPLE = ("table", _a(3, 4, seed=1), _a(3, 4, seed=2), _a(3, 4, seed=3))
NESTED = ("table", _a(2, 3, seed=1),
          ("table", _a(2, 2, seed=2), ("table", _a(2, 5, seed=3))),
          _a(2, 1, seed=4))


def _lin(nn, n_in, n_out, seed, **kw):
    if nn is tnn:
        kw = {"device": "cpu", "generator": torch.Generator().manual_seed(
            seed)}
    return nn.Linear(n_in, n_out, **kw)


#: name -> (factory of the package `nn`, input)
CASES = {
    "ParallelTable": (lambda nn: nn.ParallelTable().add(_lin(nn, 4, 2, 1))
                      .add(_lin(nn, 4, 3, 2)), PAIR),
    "MapTable": (lambda nn: nn.MapTable().add(_lin(nn, 4, 2, 3)), TRIPLE),
    "Bottle": (lambda nn: nn.Bottle(_lin(nn, 4, 3, 4), 2),
               _a(2, 5, 4, seed=5)),
    "CSubTable": (lambda nn: nn.CSubTable(), PAIR),
    "CMulTable": (lambda nn: nn.CMulTable(), TRIPLE),
    "CDivTable": (lambda nn: nn.CDivTable(),
                  ("table", _a(3, 4, seed=1), _a(3, 4, seed=2,
                                                 positive=True))),
    "CMaxTable": (lambda nn: nn.CMaxTable(), TRIPLE),
    "CMinTable": (lambda nn: nn.CMinTable(), TRIPLE),
    "CAveTable": (lambda nn: nn.CAveTable(), TRIPLE),
    "JoinTable": (lambda nn: nn.JoinTable(1),
                  ("table", _a(2, 3, seed=1), _a(2, 5, seed=2))),
    "SplitTable": (lambda nn: nn.SplitTable(1), _a(2, 3, 4, seed=6)),
    "FlattenTable": (lambda nn: nn.FlattenTable(), NESTED),
    "SelectTable": (lambda nn: nn.SelectTable(2), TRIPLE),
    "SelectTable_from_the_end": (lambda nn: nn.SelectTable(-1), TRIPLE),
    "NarrowTable": (lambda nn: nn.NarrowTable(2, 2), TRIPLE),
    "MixtureTable": (lambda nn: nn.MixtureTable(),
                     ("table", _a(3, 2, seed=7),
                      ("table", _a(3, 4, seed=8), _a(3, 4, seed=9)))),
    "MixtureTable_stacked": (lambda nn: nn.MixtureTable(),
                             ("table", _a(3, 2, seed=7),
                              _a(3, 2, 4, seed=8))),
    "BifurcateSplitTable": (lambda nn: nn.BifurcateSplitTable(1),
                            _a(2, 5, 3, seed=10)),
    "Echo": (lambda nn: nn.Echo(), _a(2, 4, seed=11)),
}


def _port_in(x):
    if isinstance(x, tuple):
        return T(*[_port_in(v) for v in x[1:]])
    return torch.from_numpy(x).requires_grad_()


def _jax_in(x):
    if isinstance(x, tuple):
        return JT(*[_jax_in(v) for v in x[1:]])
    return jnp.asarray(x)


def _leaves(v):
    if isinstance(v, (Table, JTable)):
        return [x for item in v for x in _leaves(item)]
    return [v]


def _weights(out):
    return [np.random.RandomState(20 + i).randn(*np.shape(o)).astype(
        np.float32) for i, o in enumerate(_leaves(out))]


def _np_tree(t):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in t.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_container_matches_jax(name, capsys):
    factory, x = CASES[name]
    tm, jm = factory(tnn), factory(jnn)
    params = module_params_tree(tm)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    capsys.readouterr()
    xin = _port_in(x)
    out = tm(xin)
    port_print = capsys.readouterr().out
    jout, _ = jfunctional_apply(jm, jparams, _jax_in(x))
    jax_print = capsys.readouterr().out
    assert port_print == jax_print
    got, want = _leaves(out), _leaves(jout)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL)
    ws = _weights(jout)

    def f(p, xx):
        o, _ = jfunctional_apply(jm, p, xx)
        return sum(jnp.sum(a * w) for a, w in zip(_leaves(o), ws))
    jgp, jgx = jax.grad(f, argnums=(0, 1))(jparams, _jax_in(x))
    sum((a * torch.from_numpy(w)).sum() for a, w in zip(got, ws)).backward()
    for gx, want_gx in zip(_leaves(xin), _leaves(jgx)):
        got_gx = np.zeros(tuple(gx.shape), np.float32) if gx.grad is None \
            else gx.grad.numpy()
        np.testing.assert_allclose(got_gx, np.asarray(want_gx),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)
    tgrad = module_params_tree(tm, grad=True) if params else {}
    jgrad = _np_tree(jgp)

    def walk(a, b, path=""):
        assert set(a) == set(b), path
        for k in b:
            if isinstance(b[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
            else:
                np.testing.assert_allclose(a[k], b[k], rtol=GRAD_RTOL,
                                           atol=GRAD_ATOL,
                                           err_msg=f"{path}/{k}")
    walk(tgrad, jgrad)
