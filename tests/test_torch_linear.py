"""Port parity: the `linear.py` family of `bigdl_tpu_torch.nn` (`Bilinear`,
`CMul`, `CAdd`, `Mul`, `Add`, `MulConstant`, `AddConstant`, `Maxout`,
`Highway`, `Scale`, `Cosine`, `Euclidean`) against `bigdl_tpu.nn`, with
the JAX layer's parameters carried into the port
(`interop.load_module_params`), never initialised anew.

Inputs come from numpy with fixed seeds. Each case compares the output
and the gradients of `sum(out * w)` (a random `w`) with respect to the
input and every parameter against `jax.value_and_grad` of the reference,
in f32 (tests/conftest.py sets JAX's matmul precision to "highest"):
outputs and input gradients within atol 1e-5, parameter gradients within
1e-5 of their tensor's largest element (the same products summed in
another order). The parameter trees' keys and shapes equal the JAX
layer's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
from bigdl_tpu.nn.module import functional_apply
from bigdl_tpu.utils.table import T as JT
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.interop import load_module_params, module_params_tree
from bigdl_tpu_torch.utils import T

ATOL = 1e-5
GRAD_RTOL = 1e-5
CPU = {"device": "cpu"}


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


#: name -> (JAX layer, port layer, input shapes: one, or a pair of a Table)
CASES = {
    "Bilinear": (lambda: jnn.Bilinear(3, 4, 5),
                 lambda: tnn.Bilinear(3, 4, 5, **CPU), [(2, 3), (2, 4)]),
    "Bilinear_no_bias": (lambda: jnn.Bilinear(3, 4, 5, False),
                         lambda: tnn.Bilinear(3, 4, 5, False, **CPU),
                         [(2, 3), (2, 4)]),
    "CMul": (lambda: jnn.CMul((1, 4)), lambda: tnn.CMul((1, 4), **CPU),
             (3, 4)),
    "CMul_3d": (lambda: jnn.CMul((2, 1, 4)),
                lambda: tnn.CMul((2, 1, 4), **CPU), (2, 3, 4)),
    "CAdd": (lambda: jnn.CAdd((1, 4)), lambda: tnn.CAdd((1, 4), **CPU),
             (3, 4)),
    "Mul": (lambda: jnn.Mul(), lambda: tnn.Mul(**CPU), (3, 4)),
    "Add": (lambda: jnn.Add(4), lambda: tnn.Add(4, **CPU), (3, 4)),
    "MulConstant": (lambda: jnn.MulConstant(2.5),
                    lambda: tnn.MulConstant(2.5), (3, 4)),
    "AddConstant": (lambda: jnn.AddConstant(-1.5),
                    lambda: tnn.AddConstant(-1.5), (3, 4)),
    "Maxout": (lambda: jnn.Maxout(4, 3, 2),
               lambda: tnn.Maxout(4, 3, 2, **CPU), (5, 4)),
    "Highway": (lambda: jnn.Highway(4), lambda: tnn.Highway(4, **CPU),
                (3, 4)),
    "Highway_no_bias": (lambda: jnn.Highway(4, False),
                        lambda: tnn.Highway(4, False, **CPU), (3, 4)),
    "Scale": (lambda: jnn.Scale((1, 4)), lambda: tnn.Scale((1, 4), **CPU),
              (3, 4)),
    "Cosine": (lambda: jnn.Cosine(4, 3), lambda: tnn.Cosine(4, 3, **CPU),
               (5, 4)),
    "Euclidean": (lambda: jnn.Euclidean(4, 3),
                  lambda: tnn.Euclidean(4, 3, **CPU), (5, 4)),
}


def _np(tree):
    return {k: _np(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else np.asarray(tree)


def _close_tree(got, want, rtol=GRAD_RTOL):
    assert got.keys() == want.keys()
    for k in got:
        if isinstance(want[k], dict):
            _close_tree(got[k], want[k], rtol)
            continue
        b = np.asarray(want[k])
        assert got[k].shape == b.shape, k
        np.testing.assert_allclose(
            got[k], b, rtol=0, atol=rtol * max(float(np.abs(b).max()), 1e-6))


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_the_reference(case):
    jf, tf, shapes = CASES[case]
    jm, tm = jf(), tf()
    params = _np(jm.init(jax.random.PRNGKey(3)))
    load_module_params(tm, params)
    table = isinstance(shapes, list)
    xs = [_x(*s, seed=i) for i, s in enumerate(shapes if table
                                              else [shapes])]
    jx = JT(*map(jnp.asarray, xs)) if table else jnp.asarray(xs[0])
    out0, _ = functional_apply(jm, params, jx, training=True)
    w = _x(*np.shape(out0), seed=9)

    def f(p, xx):
        out, _ = functional_apply(jm, p, xx, training=True)
        return jnp.sum(out * w), out
    (_, out_j), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1),
                                              has_aux=True)(params, jx)
    txs = [torch.from_numpy(x).requires_grad_() for x in xs]
    out_t = tm.train()(T(*txs) if table else txs[0])
    (out_t * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=ATOL, rtol=0)
    gxs = list(gx) if table else [gx]
    for t, g in zip(txs, gxs):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   atol=ATOL, rtol=0)
    if params:
        _close_tree(module_params_tree(tm, grad=True), _np(gp))
    else:
        assert list(tm.parameters()) == []


@pytest.mark.parametrize("case", sorted(CASES))
def test_parameter_tree_is_the_reference_s(case):
    """Keys, nesting and shapes of the port's tree equal the JAX init's."""
    jf, tf, _ = CASES[case]
    want = _np(jf().init(jax.random.PRNGKey(0)))
    got = module_params_tree(tf())

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else v.shape
                for k, v in t.items()}
    assert shapes(got) == shapes(want)


def test_default_inits_draw_from_the_generator():
    """One seed, one set of weights; another seed, others."""
    a = tnn.Bilinear(3, 4, 5, **CPU,
                     generator=torch.Generator().manual_seed(1))
    b = tnn.Bilinear(3, 4, 5, **CPU,
                     generator=torch.Generator().manual_seed(1))
    c = tnn.Bilinear(3, 4, 5, **CPU,
                     generator=torch.Generator().manual_seed(2))
    assert torch.equal(a.weight, b.weight)
    assert not torch.equal(a.weight, c.weight)
    stdv = 1.0 / np.sqrt(3)
    assert float(a.weight.detach().abs().max()) <= stdv


def test_highway_takes_another_activation():
    jm, tm = jnn.Highway(4, True, jax.nn.relu), \
        tnn.Highway(4, True, torch.relu, **CPU)
    params = _np(jm.init(jax.random.PRNGKey(5)))
    load_module_params(tm, params)
    x = _x(3, 4, seed=2)
    want, _ = functional_apply(jm, params, jnp.asarray(x))
    got = tm.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
