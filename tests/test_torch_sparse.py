"""Port parity: the sparse stack against `bigdl_tpu` on the CPU.

- `SparseTensor` / `SparseTensorMath` (`bigdl_tpu_torch/tensor/sparse.py`):
  every case of `tests/test_sparse.py`'s `TestSparseTensorMath` and
  `TestSparseTensorSurface`, plus `narrow`, `dot`, the metadata and
  `concat` along dim 2, run on both packages' tensors from the same
  numpy arrays: integer results exact, float results within rtol 1e-6
  (atol 1e-6 for the sums of cancelling terms), the same exceptions.
- `LookupTableSparse` (every combiner, ids alone or weighted, 0 as
  padding, a finite `max_norm`), `SparseLinear` (-1 as padding, an index
  past `input_size - 1`, float ids, the dense route) and
  `SparseJoinTable`: outputs and the gradients of the parameters and the
  values against `jax.grad`, with the JAX weights carried over, within
  rtol 1e-5 and atol 1e-6 (the same f32 sums in another order).
- `DenseToSparse` is the identity in both.
- The eight feature-column ops (`bigdl_tpu_torch/ops/feature_col.py`) on
  strings, bytes, ints, negative and out-of-range ids and OOV buckets:
  equal results (the crc32 buckets included).
- The MovieLens reader on a `ratings.dat` and a `ratings.csv` written to
  `tmp_path`: equal arrays.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
import bigdl_tpu.ops as jops
from bigdl_tpu.dataset import movielens as jml
from bigdl_tpu.nn.module import functional_apply
from bigdl_tpu.tensor import SparseTensor as JSparse
from bigdl_tpu.tensor import SparseTensorMath as JMath
from bigdl_tpu.utils.table import T as JT
import bigdl_tpu_torch.nn as tnn
import bigdl_tpu_torch.ops as tops
from bigdl_tpu_torch.dataset import movielens as tml
from bigdl_tpu_torch.interop import load_module_params, module_params_tree
from bigdl_tpu_torch.tensor import SparseTensor as TSparse
from bigdl_tpu_torch.tensor import SparseTensorMath as TMath
from bigdl_tpu_torch.utils import T

RTOL, ATOL = 1e-6, 1e-6
LAYER_RTOL, LAYER_ATOL = 1e-5, 1e-6


# --------------------------------------------------------------------------
# SparseTensor: one case function, run on each package
# --------------------------------------------------------------------------

class _Jax:
    ST, M = JSparse, JMath
    bf16 = jnp.bfloat16

    @staticmethod
    def arr(a):
        return jnp.asarray(a)

    @staticmethod
    def from_dense(a):
        return JSparse.from_dense(a)

    @staticmethod
    def dense(sp):
        return np.asarray(sp.to_dense().to_numpy())

    @staticmethod
    def np(x):
        return np.asarray(x)


class _Port:
    ST, M = TSparse, TMath
    bf16 = torch.bfloat16

    @staticmethod
    def arr(a):
        return torch.from_numpy(np.asarray(a))

    @staticmethod
    def from_dense(a):
        return TSparse.from_dense(a, device="cpu")

    @staticmethod
    def dense(sp):
        return sp.to_dense().numpy()

    @staticmethod
    def np(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rand_dense(seed, shape, density=0.3):
    rs = np.random.RandomState(seed)
    dense = rs.randn(*shape).astype(np.float32)
    dense[rs.rand(*shape) > density] = 0.0
    return rs, dense


def case_vdot(k):
    rs, dense = _rand_dense(0, (7, 5))
    v = rs.randn(7, 5).astype(np.float32)
    return {"vdot": float(k.M.vdot(k.arr(v), k.from_dense(dense)))}


def case_dot_empty_and_3d(k):
    rs, dense = _rand_dense(10, (3, 4, 2), 0.5)
    v = rs.randn(24).astype(np.float32)
    empty = k.from_dense(np.zeros((2, 3), np.float32))
    return {"dot": float(k.from_dense(dense).dot(k.arr(v))),
            "empty": float(empty.dot(k.arr(np.ones(6, np.float32))))}


def case_addmv(k):
    rs, dense = _rand_dense(1, (6, 4))
    vec = rs.randn(4).astype(np.float32)
    t = rs.randn(6).astype(np.float32)
    sp = k.from_dense(dense)
    return {"addmv": k.np(k.M.addmv(0.5, k.arr(t), 2.0, sp, k.arr(vec))),
            "plain": k.np(sp.addmv(k.arr(vec)))}


def case_addmv_shape_checks(k):
    _, dense = _rand_dense(2, (6, 4))
    with pytest.raises(ValueError):
        k.from_dense(dense).addmv(k.arr(np.zeros((5,), np.float32)))
    return {}


def case_addmm_sparse_dense(k):
    rs, dense = _rand_dense(3, (6, 4))
    m = rs.randn(4, 3).astype(np.float32)
    m3 = rs.randn(6, 3).astype(np.float32)
    return {"addmm": k.np(k.M.addmm(0.25, k.arr(m3), 2.0,
                                    k.from_dense(dense), k.arr(m)))}


def case_addmm_dense_sparse(k):
    rs, dense = _rand_dense(4, (4, 7))
    m = rs.randn(5, 4).astype(np.float32)
    m3 = rs.randn(5, 7).astype(np.float32)
    return {"addmm": k.np(k.M.addmm(0.5, k.arr(m3), 3.0, k.arr(m),
                                    k.from_dense(dense))),
            "no_out": k.np(k.M.addmm(0.0, None, 1.0, k.arr(m),
                                     k.from_dense(dense)))}


def case_addmm_neither_sparse_raises(k):
    z = k.arr(np.zeros((2, 2), np.float32))
    with pytest.raises(TypeError):
        k.M.addmm(0.0, None, 1.0, z, z)
    return {}


def case_sum_total_and_dim(k):
    rs, dense = _rand_dense(5, (5, 6))
    sp = k.from_dense(dense)
    dense3 = rs.randn(3, 4, 2).astype(np.float32)
    dense3[rs.rand(3, 4, 2) > 0.4] = 0.0
    sp3 = k.from_dense(dense3)
    return {"total": float(sp.sum()), "dim1": k.np(sp.sum(1)),
            "dim2": k.np(sp.sum(2)), "3d_dim2": k.np(sp3.sum(2)),
            "3d_dim3": k.np(sp3.sum(3))}


def case_num_non_zero_by_row(k):
    dense = np.array([[1, 0, 2], [0, 0, 0], [3, 4, 5]], np.float32)
    sp = k.from_dense(dense)
    return {"by_row": k.np(sp.num_non_zero_by_row()),
            "alias": k.np(sp.numNonZeroByRow())}


def case_cast_and_apply_fun(k):
    dense = np.array([[1.5, 0.0], [0.0, -2.5]], np.float32)
    sp = k.from_dense(dense)
    assert sp.cast(k.bf16).values.dtype == k.bf16
    return {"doubled": k.dense(sp.apply_fun(lambda v: v * 2)),
            "apply1": k.dense(sp.apply1(lambda v: v - 1))}


def case_get_element(k):
    sp = k.from_dense(np.array([[0.0, 7.0], [3.0, 0.0]], np.float32))
    return {"get": [sp.get(1, 2), sp.get(2, 1), sp.get(1, 1)]}


def case_resize_set_copy(k):
    sp = k.from_dense(np.eye(3, dtype=np.float32))
    sp.resize((4, 4), nnz=5)
    out = {"shape": sp.shape, "nnz": sp.nnz()}
    other = k.from_dense(np.eye(2, dtype=np.float32))
    sp.set_(other)
    assert sp == other
    fresh = k.from_dense(np.zeros((2, 2), np.float32))
    fresh.resize((2, 2), nnz=2)
    fresh.copy_(other)
    out["copied"] = k.dense(fresh)
    return out


def case_resize_shrink_drops_out_of_bounds(k):
    sp = k.from_dense(np.diag([1.0, 2.0, 3.0, 4.0]).astype(np.float32))
    sp.resize((2, 2))
    return {"nnz": sp.nnz(), "dense": k.dense(sp)}


def case_unhashable_mutable_container(k):
    with pytest.raises(TypeError):
        hash(k.from_dense(np.eye(2, dtype=np.float32)))
    return {}


def case_addmm_shape_mismatch_raises(k):
    _, dense = _rand_dense(6, (4, 7))
    sp = k.from_dense(dense)
    with pytest.raises(ValueError):
        sp.addmm(k.arr(np.zeros((5, 3), np.float32)))
    with pytest.raises(ValueError):
        k.M.addmm(0.0, None, 1.0, k.arr(np.zeros((5, 3), np.float32)), sp)
    return {}


def case_concat(k):
    a = k.from_dense(np.array([[1.0, 0.0]], np.float32))
    b = k.from_dense(np.array([[0.0, 2.0]], np.float32))
    _, big = _rand_dense(7, (3, 4), 0.5)
    _, other = _rand_dense(8, (3, 2), 0.5)
    j2 = k.ST.concat([k.from_dense(big), k.from_dense(other)])
    return {"dim1": k.dense(k.ST.concat([a, b], dim=1)),
            "dim2": k.dense(j2), "shape2": j2.shape,
            "indices2": [k.np(ix) for ix in j2.indices]}


def case_scalar_ops(k):
    sp = k.from_dense(np.array([[2.0, 0.0], [0.0, 4.0]], np.float32))
    return {"mul": k.dense(sp * 3), "rmul": k.dense(3 * sp),
            "div": k.dense(sp / 2)}


def case_narrow_and_metadata(k):
    _, dense = _rand_dense(9, (5, 6), 0.5)
    sp = k.from_dense(dense)
    n = sp.narrow(2, 2, 3)
    return {"narrow": k.dense(n), "narrow_shape": n.shape,
            "dim": sp.dim(), "size": sp.size(), "size2": sp.size(2),
            "n_element": sp.nElement(), "nnz": sp.nnz(),
            "indices": [k.np(ix) for ix in sp.indices],
            "values": k.np(sp.values), "dense": k.dense(sp),
            "repr": repr(sp).split(", dtype")[0]}


SPARSE_CASES = {f.__name__[5:]: f for f in (
    case_vdot, case_dot_empty_and_3d, case_addmv, case_addmv_shape_checks,
    case_addmm_sparse_dense, case_addmm_dense_sparse,
    case_addmm_neither_sparse_raises, case_sum_total_and_dim,
    case_num_non_zero_by_row, case_cast_and_apply_fun, case_get_element,
    case_resize_set_copy, case_resize_shrink_drops_out_of_bounds,
    case_unhashable_mutable_container, case_addmm_shape_mismatch_raises,
    case_concat, case_scalar_ops, case_narrow_and_metadata)}


def _same(got, want, path):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            _same(got[key], want[key], f"{path}/{key}")
    elif isinstance(want, (list, tuple)) and not isinstance(want, str):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, str):
        assert got == want, path
    else:
        want = np.asarray(want)
        got = np.asarray(got)
        assert got.shape == want.shape, path
        if want.dtype.kind in "iub":
            np.testing.assert_array_equal(got, want, err_msg=path)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=path)


@pytest.mark.parametrize("name", sorted(SPARSE_CASES))
def test_sparse_tensor_matches_the_reference(name):
    fn = SPARSE_CASES[name]
    _same(fn(_Port), fn(_Jax), name)


def test_sparse_tensor_keeps_int32_coordinates_and_its_device():
    sp = TSparse.from_dense(np.eye(3, dtype=np.float32), device="cpu")
    assert all(ix.dtype == torch.int32 for ix in sp.indices)
    assert sp.device == torch.device("cpu")
    assert isinstance(sp.to_dense(), torch.Tensor)
    # a tensor's own device is taken when none is named
    t = TSparse([np.array([0, 1])], torch.ones(2), (3,))
    assert t.device == torch.device("cpu")
    with pytest.raises(ValueError):
        TSparse([np.array([0, 1, 2])], torch.ones(2), (3,))


# --------------------------------------------------------------------------
# The sparse layers against jax.grad
# --------------------------------------------------------------------------

def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def _carry(jlayer, tlayer, seed):
    params = _np_tree(jlayer.init(jax.random.PRNGKey(seed)))
    load_module_params(tlayer, params)
    return params


def _grads_both(jlayer, tlayer, params, jin, tin, val_key=None):
    """(output, param grads, values grad) of sum(out * out) in both
    packages; the values are item `val_key` of a Table input."""
    def jloss(p, vals):
        x = jin if val_key is None else JT(jin[1], vals)
        out, _ = functional_apply(jlayer, p, x, training=True)
        return jnp.sum(out * out), out

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jvals = None if val_key is None else jin[val_key]
    (_, jout), (jg, jgv) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jvals if jvals is not None
                                             else jnp.zeros(()))
    if val_key is not None:
        tvals = tin[val_key].clone().requires_grad_(True)
        tin = T(tin[1], tvals)
    tout = tlayer(tin)
    (tout * tout).sum().backward()
    return ((tout.detach().numpy(), module_params_tree(tlayer, grad=True),
             None if val_key is None else tvals.grad.numpy()),
            (np.asarray(jout), _np_tree(jg),
             None if val_key is None else np.asarray(jgv)))


def _close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            _close(got[key], want[key], f"{path}/{key}")
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=LAYER_RTOL, atol=LAYER_ATOL,
                               err_msg=path)


def _bag_inputs(seed, n_index, b=4, l=5, float_ids=False):
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, n_index + 1, (b, l)).astype(np.int32)
    ids[0, 2] = 0  # padding
    ids[1, 3:] = 0
    ids[2, :] = 0  # an empty bag
    wts = rs.rand(b, l).astype(np.float32) + 0.1
    if float_ids:
        ids = ids.astype(np.float32) + 0.4  # truncated to the same ids
    return ids, wts


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("weighted,max_norm", [(True, -1.0), (False, 1.5),
                                               (True, 1.5)])
def test_lookup_table_sparse_matches_jax_grad(combiner, max_norm, weighted):
    n_index, n_out = 10, 6
    jl = jnn.LookupTableSparse(n_index, n_out, combiner=combiner,
                               max_norm=max_norm)
    tl = tnn.LookupTableSparse(n_index, n_out, combiner=combiner,
                               max_norm=max_norm, device="cpu")
    params = _carry(jl, tl, 3)
    ids, wts = _bag_inputs(4, n_index, float_ids=not weighted)
    if weighted:
        jin = JT(jnp.asarray(ids), jnp.asarray(wts))
        tin = T(torch.from_numpy(ids), torch.from_numpy(wts))
        got, want = _grads_both(jl, tl, params, jin, tin, val_key=2)
    else:
        got, want = _grads_both(jl, tl, params, jnp.asarray(ids),
                                torch.from_numpy(ids))
    _close(got[0], want[0], "out")
    _close(got[1], want[1], "grads")
    if weighted:
        _close(got[2], want[2], "weights grad")
    # the empty bag gives a zero row
    assert not got[0][2].any()


def _wide_inputs(seed, in_dim, b=4, l=5, float_ids=False):
    rs = np.random.RandomState(seed)
    idx = rs.randint(0, in_dim, (b, l)).astype(np.int32)
    idx[1, 3] = -1  # padding
    idx[3, :2] = -1
    idx[0, 0] = in_dim  # past the last row: clipped to it
    idx[2, 4] = in_dim + 7
    vals = rs.randn(b, l).astype(np.float32)
    if float_ids:
        idx = idx.astype(np.float32)
        idx[idx >= 0] += 0.7  # truncated toward zero
    return idx, vals


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("float_ids", [False, True])
def test_sparse_linear_matches_jax_grad(with_bias, float_ids):
    in_dim, out_dim = 12, 3
    jl = jnn.SparseLinear(in_dim, out_dim, with_bias=with_bias)
    tl = tnn.SparseLinear(in_dim, out_dim, with_bias=with_bias, device="cpu")
    params = _carry(jl, tl, 5)
    idx, vals = _wide_inputs(6, in_dim, float_ids=float_ids)
    got, want = _grads_both(
        jl, tl, params, JT(jnp.asarray(idx), jnp.asarray(vals)),
        T(torch.from_numpy(idx), torch.from_numpy(vals)), val_key=2)
    _close(got[0], want[0], "out")
    _close(got[1], want[1], "grads")
    _close(got[2], want[2], "values grad")
    # the clipped index trained the last row, and padding nothing
    assert np.abs(got[1]["weight"][-1]).sum() > 0
    assert got[2][1, 3] == 0 and not got[2][3, :2].any()


def test_sparse_linear_dense_route_and_ignored_backward_window():
    jl = jnn.SparseLinear(6, 4, True, 2, 3)
    tl = tnn.SparseLinear(6, 4, True, 2, 3, device="cpu")
    params = _carry(jl, tl, 7)
    x = np.random.RandomState(8).randn(5, 6).astype(np.float32)
    got, want = _grads_both(jl, tl, params, jnp.asarray(x),
                            torch.from_numpy(x))
    _close(got[0], want[0], "out")
    _close(got[1], want[1], "grads")


def test_sparse_join_table_offsets_match():
    rs = np.random.RandomState(9)
    slots = []
    for dim, l in ((5, 2), (7, 3), (4, 1)):
        idx = rs.randint(0, dim, (3, l)).astype(np.int32)
        idx[rs.rand(3, l) < 0.3] = -1
        slots.append((idx, rs.randn(3, l).astype(np.float32)))
    dims = [5, 7, 4]
    jout, _ = functional_apply(
        jnn.SparseJoinTable(dims),
        {}, JT(*[JT(jnp.asarray(i), jnp.asarray(v)) for i, v in slots]),
        training=False)
    tout = tnn.SparseJoinTable(dims)(
        T(*[T(torch.from_numpy(i), torch.from_numpy(v)) for i, v in slots]))
    assert len(tout) == 2
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
    assert tout[1].dtype == torch.int32
    # padding stays -1; slot 2's ids start at 5, slot 3's at 12
    assert (tout[1][:, 2:5][slots[1][0] >= 0] >= 5).all()
    assert ((tout[1] == -1).numpy() == np.concatenate(
        [i for i, _ in slots], 1).__eq__(-1)).all()


def test_sparse_join_table_feeds_sparse_linear():
    """The reference's wide composition: joined slots into one
    SparseLinear over the summed width."""
    rs = np.random.RandomState(10)
    slots = [(rs.randint(0, 4, (2, 2)).astype(np.int32),
              rs.rand(2, 2).astype(np.float32)),
             (rs.randint(0, 6, (2, 3)).astype(np.int32),
              rs.rand(2, 3).astype(np.float32))]
    jm = jnn.Sequential().add(jnn.SparseJoinTable([4, 6])) \
        .add(jnn.SparseLinear(10, 2))
    tm = tnn.Sequential().add(tnn.SparseJoinTable([4, 6])) \
        .add(tnn.SparseLinear(10, 2, device="cpu"))
    params = _carry(jm, tm, 11)
    jout, _ = functional_apply(
        jm, jax.tree_util.tree_map(jnp.asarray, params),
        JT(*[JT(jnp.asarray(i), jnp.asarray(v)) for i, v in slots]),
        training=False)
    tout = tm(T(*[T(torch.from_numpy(i), torch.from_numpy(v))
                  for i, v in slots]))
    _close(tout.detach().numpy(), np.asarray(jout), "out")


def test_dense_to_sparse_is_the_identity():
    x = np.random.RandomState(12).randn(3, 4).astype(np.float32)
    jout, _ = functional_apply(jnn.DenseToSparse(), {}, jnp.asarray(x),
                               training=False)
    t = torch.from_numpy(x)
    assert tnn.DenseToSparse()(t) is t
    np.testing.assert_array_equal(t.numpy(), np.asarray(jout))


# --------------------------------------------------------------------------
# Feature columns
# --------------------------------------------------------------------------

WORDS = np.array([["cat", "dog", "emu"], ["fish", "cat", ""],
                  ["dog", "yak", "cat"]])

#: name -> (reference op, port op (device="cpu"), input)
FEATURE_CASES = {
    "bucketized_floats": (
        lambda: jops.BucketizedCol([0.0, 10.0, 100.0]),
        lambda: tops.BucketizedCol([0.0, 10.0, 100.0], device="cpu"),
        np.array([[-1.0, 15.0, 10.0], [5.0, 200.0, 100.0]], np.float32)),
    "bucketized_ints_unsorted": (
        lambda: jops.BucketizedCol([5, -3, 2]),
        lambda: tops.BucketizedCol([5, -3, 2], device="cpu"),
        np.array([-4, -3, 0, 2, 4, 5, 9], np.int32)),
    "hash_strings": (
        lambda: jops.CategoricalColHashBucket(7),
        lambda: tops.CategoricalColHashBucket(7, device="cpu"), WORDS),
    "hash_bytes": (
        lambda: jops.CategoricalColHashBucket(11),
        lambda: tops.CategoricalColHashBucket(11, device="cpu"),
        np.array([b"ab", b"cd", b"\xff\x00"])),
    "hash_ints": (
        lambda: jops.CategoricalColHashBucket(5),
        lambda: tops.CategoricalColHashBucket(5, device="cpu"),
        np.array([[1, -2], [300, 0]], np.int64)),
    "vocab_default": (
        lambda: jops.CategoricalColVocaList(["cat", "dog"], default_value=-1),
        lambda: tops.CategoricalColVocaList(["cat", "dog"], default_value=-1,
                                            device="cpu"), WORDS),
    "vocab_oov_buckets": (
        lambda: jops.CategoricalColVocaList(["cat", "dog", "emu"],
                                            num_oov_buckets=3),
        lambda: tops.CategoricalColVocaList(["cat", "dog", "emu"],
                                            num_oov_buckets=3,
                                            device="cpu"), WORDS),
    "cross": (
        lambda: jops.CrossCol(13), lambda: tops.CrossCol(13, device="cpu"),
        "cross"),
    "indicator_counts": (
        lambda: jops.IndicatorCol(5),
        lambda: tops.IndicatorCol(5, device="cpu"),
        np.array([[0, 1, 1], [4, -1, 2], [7, 3, 3]], np.int32)),
    "indicator_clipped_1d": (
        lambda: jops.IndicatorCol(4, is_count=False),
        lambda: tops.IndicatorCol(4, is_count=False, device="cpu"),
        np.array([2, 2, -3, 9, 0], np.int64)),
    "kv2tensor": (
        lambda: jops.Kv2Tensor(feat_len=5),
        lambda: tops.Kv2Tensor(feat_len=5, device="cpu"),
        np.array(["0:1.5,3:2", "", "4:-1,1:0.25,"])),
    "kv2tensor_delims": (
        lambda: jops.Kv2Tensor(";", "=", 3),
        lambda: tops.Kv2Tensor(";", "=", 3, device="cpu"),
        np.array(["2=7;0=1", "1=3"])),
    "mkstring_ints": (
        lambda: jops.MkString("-"), lambda: tops.MkString("-"),
        np.array([[1, 2, 3], [4, 5, 6]], np.int32)),
    "mkstring_strings": (
        lambda: jops.MkString(), lambda: tops.MkString(), WORDS),
    "substr_strings": (
        lambda: jops.Substr(1, 2), lambda: tops.Substr(1, 2), WORDS),
    "substr_bytes_to_end": (
        lambda: jops.Substr(1), lambda: tops.Substr(1),
        np.array([b"hello", b"x", b"\x01\x02\x03"])),
}


def _cross_input(table):
    cols = (np.array([["a", "b"], ["c", "a"]]),
            np.array([[1, 2], [3, 1]], np.int32),
            np.array([[b"x", b"y"], [b"y", b"x"]]))
    return table(*cols)


@pytest.mark.parametrize("name", sorted(FEATURE_CASES))
def test_feature_column_matches_the_reference(name):
    jop, top, x = FEATURE_CASES[name]
    jx = _cross_input(JT) if isinstance(x, str) else x
    tx = _cross_input(T) if isinstance(x, str) else x
    want, got = jop().forward(jx), top()(tx)
    if isinstance(want, np.ndarray) and want.dtype == object:
        assert isinstance(got, np.ndarray) and got.dtype == object
        assert got.shape == want.shape
        assert got.tolist() == want.tolist()
        return
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_feature_columns_take_tensors_and_raise_on_backward():
    ids = torch.tensor([[1, 3], [0, 0]])
    got = tops.IndicatorCol(4, device="cpu")(ids)
    np.testing.assert_array_equal(got.numpy(), [[0, 1, 0, 1], [2, 0, 0, 0]])
    buckets = tops.CategoricalColHashBucket(9, device="cpu")(ids)
    want = np.asarray(jops.CategoricalColHashBucket(9).forward(ids.numpy()))
    np.testing.assert_array_equal(buckets.numpy(), want)
    with pytest.raises(RuntimeError, match="backward"):
        tops.IndicatorCol(4, device="cpu").backward()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tops.IndicatorCol(4)


# --------------------------------------------------------------------------
# MovieLens
# --------------------------------------------------------------------------

def test_movielens_reader_matches_the_reference(tmp_path):
    dat = tmp_path / "ml1m"
    dat.mkdir()
    (dat / "ratings.dat").write_text(
        "1::1193::5::978300760\n1::661::3::978302109\n\n"
        "2::3068::4::978299000\n7::5::1::9\n")
    csv = tmp_path / "latest"
    csv.mkdir()
    (csv / "ratings.csv").write_text(
        "userId,movieId,rating,timestamp\n1,31,2.5,1260759144\n"
        "1,1029,3.0,1260759179\n4,10,4.5,1\nbad\n")
    for d in (dat, csv):
        want = jml.read_data_sets(str(d))
        got = tml.read_data_sets(str(d))
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tml.get_id_pairs(str(d)),
                                      jml.get_id_pairs(str(d)))
        np.testing.assert_array_equal(tml.get_id_ratings(str(d)),
                                      jml.get_id_ratings(str(d)))
    assert tml.read_data_sets(str(csv)).tolist() == [[1, 31, 2], [1, 1029, 3],
                                                     [4, 10, 4]]
    with pytest.raises(FileNotFoundError):
        tml.read_data_sets(str(tmp_path))
