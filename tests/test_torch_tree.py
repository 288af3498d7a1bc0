"""Port parity: `bigdl_tpu_torch.nn.tree` (`TreeLSTM`, `BinaryTreeLSTM`)
and `tools/treelstm_sentiment.py` against `bigdl_tpu`.

`BinaryTreeLSTM` takes the reference's `Table(embeddings [B, L, D], tree
[B, N, 3])` (1-based `(left, right, leaf)` rows, all-zero rows padding)
with the JAX layer's parameters carried into the port, never initialised
anew; inputs from numpy with fixed seeds. The node hiddens and the input
gradient of `sum(out * w)` within atol 1e-5 and each parameter gradient
within 1e-4 of its tensor's largest element, f32 (the same products
summed in another order; tests/conftest.py sets JAX's matmul precision
to "highest"). The example's corpus and trees equal the reference
example's, and a reduced run learns above chance on the CPU.
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
from bigdl_tpu_torch.tools import treelstm_sentiment
from bigdl_tpu_torch.utils import T

ATOL = 1e-5
GRAD_RTOL = 1e-4


def _np(tree):
    return {k: _np(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else np.asarray(tree)


def _trees():
    """Two sentences of a batch: a right-branching tree of 4 leaves with
    two padding rows after its root, and a left-branching one of 3 leaves
    (its composers read a composer and a leaf) with a padding row between
    its leaves and its composers."""
    right = treelstm_sentiment.right_branching_tree(4)
    right = np.concatenate([right, np.zeros((2, 3), np.int32)])
    left = np.array([[0, 0, 1], [0, 0, 2], [0, 0, 3], [0, 0, 0],
                     [1, 2, 0], [5, 3, 0], [0, 0, 0], [0, 0, 0],
                     [0, 0, 0]], np.int32)
    return np.stack([right, left])


def _rand_biases(params, seed=3):
    """The biases init at zero: give them values the test sees."""
    rs = np.random.RandomState(seed)
    return {k: (rs.randn(*v.shape) * 0.3).astype(np.float32)
            if k.endswith("_b") else v for k, v in params.items()}


@pytest.mark.parametrize("gate_output", [True, False])
def test_binary_tree_lstm_matches_the_reference(gate_output):
    jm = jnn.BinaryTreeLSTM(3, 4, gate_output)
    tm = tnn.BinaryTreeLSTM(3, 4, gate_output, device="cpu")
    params = _rand_biases(_np(jm.init(jax.random.PRNGKey(1))))
    load_module_params(tm, params)
    emb = np.random.RandomState(0).randn(2, 4, 3).astype(np.float32)
    tree = _trees()

    def f(p, e):
        out, _ = functional_apply(jm, p, JT(e, jnp.asarray(tree)))
        return jnp.sum(out * w), out
    out0, _ = functional_apply(jm, params, JT(jnp.asarray(emb),
                                              jnp.asarray(tree)))
    w = np.random.RandomState(9).randn(*out0.shape).astype(np.float32)
    (_, out_j), (gp, ge) = jax.value_and_grad(f, argnums=(0, 1),
                                              has_aux=True)(
        params, jnp.asarray(emb))
    et = torch.from_numpy(emb).requires_grad_()
    out_t = tm(T(et, torch.from_numpy(tree)))
    (out_t * torch.from_numpy(w)).sum().backward()
    assert out_t.shape == (2, 9, 4)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=ATOL, rtol=0)
    # padding rows hold zero states
    assert not out_t[0, 7:].any() and not out_t[1, 3].any()
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(ge), atol=ATOL,
                               rtol=0)
    got = module_params_tree(tm, grad=True)
    assert got.keys() == gp.keys()
    for k, b in _np(gp).items():
        np.testing.assert_allclose(
            got[k], b, rtol=0,
            atol=GRAD_RTOL * max(float(np.abs(b).max()), 1e-6))


def test_tree_lstm_base_and_parameter_tree():
    base = tnn.TreeLSTM(3, 4)
    assert (base.input_size, base.hidden_size) == (3, 4)
    want = _np(jnn.BinaryTreeLSTM(3, 4).init(jax.random.PRNGKey(0)))
    got = module_params_tree(tnn.BinaryTreeLSTM(3, 4, device="cpu"))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert not got["leaf_b"].any() and not got["comp_b"].any()


def test_the_example_s_corpus_and_trees_are_the_reference_s():
    from examples import treelstm_sentiment as ref
    x, y = treelstm_sentiment.make_corpus(16, 5, 4)
    rx, ry = ref._make_corpus(16, 5, 4)
    assert np.array_equal(x, rx) and np.array_equal(y, ry)
    for n in (1, 2, 6):
        assert np.array_equal(treelstm_sentiment.right_branching_tree(n),
                              ref._right_branching_tree(n))


def test_the_example_learns_above_chance_on_the_cpu():
    acc = treelstm_sentiment.main(["--device", "cpu", "--sentences", "64",
                                   "--max-iteration", "30"])
    assert acc > 0.7  # chance is about 0.5
