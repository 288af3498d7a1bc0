"""COO sparse tensor (counterpart of `bigdl_tpu/tensor/sparse.py`).

The reference's `SparseTensor` surface: the metadata (`dim`, `size`,
`nElement`, `nnz`), `from_dense` / `to_dense`, `narrow`, `concat`, the
products (`addmm`, `addmv`, `dot`), `sum`, `num_non_zero_by_row`,
`cast`, `apply_fun`, `get`, `resize`, `set_`, `copy_`, equality and the
scalar operators; `SparseTensorMath` holds the module-level products
(`vdot`, `addmv`, `addmm` with either operand sparse).

The coordinates are int32 tensors, one a dimension, beside a values
tensor on the same device. A row (or column) bucket is an `index_add_`
over the coordinate, where the reference uses `jax.ops.segment_sum`.
Differences from the reference:
- `to_dense()` returns a `torch.Tensor`; the reference returns its
  Torch-style `Tensor` facade, which is not ported (`ROADMAP.md` queue 1
  item 10);
- `to_jax_dense` has no counterpart;
- `dot` linearises the coordinates in int64, so it takes any index space
  (the reference refuses one past int32, jax's index type).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch._device import resolve_device


def _device_of(values, device) -> torch.device:
    """`device` when given, else the values' own when they are a tensor,
    else the default (`resolve_device`)."""
    if device is None and isinstance(values, torch.Tensor):
        return values.device
    return resolve_device(device)


def _as_tensor(x, device: torch.device, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device=device, dtype=dtype or t.dtype)


class SparseTensor:
    """COO: `indices[d][k]` is the 0-based d-th coordinate of entry k.
    `device` (keyword-only): where the tensor lives; default the values'
    device when they are a tensor, else the card."""

    def __init__(self, indices, values, shape: Sequence[int], *,
                 device=None):
        dev = _device_of(values, device)
        self.indices: Tuple[torch.Tensor, ...] = tuple(
            _as_tensor(ix, dev, torch.int32) for ix in indices)
        self.values = _as_tensor(values, dev)
        self.shape = tuple(int(s) for s in shape)
        if self.indices and any(
                ix.shape != self.values.shape for ix in self.indices):
            raise ValueError("indices/values length mismatch")

    @property
    def device(self) -> torch.device:
        return self.values.device

    # ------------------------------------------------------------ metadata
    def dim(self) -> int:
        return len(self.shape)

    def size(self, d=None):
        if d is None:
            return self.shape
        return self.shape[d - 1]  # 1-based like Tensor

    def nElement(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def nnz(self) -> int:
        return int(self.values.shape[0])

    def _long(self, d: int) -> torch.Tensor:
        return self.indices[d].long()

    # --------------------------------------------------------- conversion
    @classmethod
    def from_dense(cls, dense, *, device=None) -> "SparseTensor":
        """The non-zero entries of `dense` (a numpy array or a tensor),
        in row-major order."""
        arr = dense.detach().cpu().numpy() if isinstance(
            dense, torch.Tensor) else np.asarray(dense)
        if device is None and isinstance(dense, torch.Tensor):
            device = dense.device
        coords = np.nonzero(arr)
        return cls(tuple(c.astype(np.int32) for c in coords), arr[coords],
                   arr.shape, device=device)

    def to_dense(self) -> torch.Tensor:
        """The dense tensor: duplicate coordinates add up."""
        out = torch.zeros(self.shape, dtype=self.values.dtype,
                          device=self.device)
        if self.nnz():
            out.index_put_(tuple(ix.long() for ix in self.indices),
                           self.values, accumulate=True)
        return out

    # ----------------------------------------------------------- slicing
    def narrow(self, dim: int, index: int, size: int) -> "SparseTensor":
        """1-based narrow along `dim`: keeps the entries with coordinate
        in [index-1, index-1+size)."""
        d = dim - 1
        lo = index - 1
        coord = self.indices[d]
        keep = (coord >= lo) & (coord < lo + size)
        new_indices = [ix[keep] for ix in self.indices]
        new_indices[d] = new_indices[d] - lo
        new_shape = list(self.shape)
        new_shape[d] = size
        return SparseTensor(new_indices, self.values[keep], new_shape)

    @classmethod
    def concat(cls, tensors: Sequence["SparseTensor"], dim: int = 2
               ) -> "SparseTensor":
        """1-based dim concat (what `nn.SparseJoinTable` does to the wide
        model's feature blocks)."""
        d = dim - 1
        out_shape = list(tensors[0].shape)
        offsets = []
        total = 0
        for t in tensors:
            offsets.append(total)
            total += t.shape[d]
        out_shape[d] = total
        parts_idx = []
        for t, off in zip(tensors, offsets):
            idx = list(t.indices)
            idx[d] = idx[d] + off
            parts_idx.append(idx)
        new_indices = [torch.cat([p[k] for p in parts_idx])
                       for k in range(len(out_shape))]
        return cls(new_indices, torch.cat([t.values for t in tensors]),
                   out_shape)

    # -------------------------------------------------------------- math
    def addmm(self, dense_mat, beta: float = 0.0, alpha: float = 1.0,
              out=None) -> torch.Tensor:
        """alpha * (self @ dense) + beta * out for a 2-D sparse self: each
        entry adds value * dense[col, :] into its row's bucket."""
        if self.dim() != 2:
            raise ValueError("addmm needs a 2-D sparse tensor")
        dense = _as_tensor(dense_mat, self.device)
        if dense.ndim != 2 or dense.shape[0] != self.shape[1]:
            raise ValueError(
                f"dense {tuple(dense.shape)} incompatible with sparse "
                f"{self.shape}")
        contrib = self.values[:, None] * dense[self._long(1)]
        prod = contrib.new_zeros((self.shape[0], dense.shape[1])).index_add_(
            0, self._long(0), contrib)
        if out is not None and beta != 0.0:
            return beta * _as_tensor(out, self.device) + alpha * prod
        return alpha * prod

    def addmv(self, dense_vec, beta: float = 0.0, alpha: float = 1.0,
              out=None) -> torch.Tensor:
        """alpha * (self @ vec) + beta * out for a 2-D sparse self."""
        if self.dim() != 2:
            raise ValueError("addmv needs a 2-D sparse tensor")
        vec = _as_tensor(dense_vec, self.device)
        if vec.ndim != 1 or vec.shape[0] != self.shape[1]:
            raise ValueError(f"vec shape {tuple(vec.shape)} incompatible "
                             f"with {self.shape}")
        contrib = self.values * vec[self._long(1)]
        prod = contrib.new_zeros(self.shape[0]).index_add_(
            0, self._long(0), contrib)
        if out is not None and beta != 0.0:
            return beta * _as_tensor(out, self.device) + alpha * prod
        return alpha * prod

    def _linear(self, dims) -> torch.Tensor:
        """The coordinates of `dims` linearised row-major (int64)."""
        lin = torch.zeros_like(self._long(0))
        stride = 1
        for d in reversed(dims):
            lin = lin + self._long(d) * stride
            stride *= self.shape[d]
        return lin

    def dot(self, dense_vec) -> torch.Tensor:
        """Sparse-dense inner product over a flat index space: only the
        stored coordinates contribute."""
        vec = _as_tensor(dense_vec, self.device)
        if not self.nnz():
            return torch.zeros((), dtype=self.values.dtype,
                               device=self.device)
        lin = self._linear(range(self.dim()))
        return torch.sum(self.values * vec.reshape(-1)[lin])

    def sum(self, dim=None):
        """The total sum, or (Torch semantics) the sum along the 1-based
        `dim`: dense, with `dim` collapsed (a [R, C] tensor summed over
        dim 2 gives the R row sums)."""
        if dim is None:
            return torch.sum(self.values)
        d = dim - 1
        rest = [i for i in range(self.dim()) if i != d]
        if not rest:
            return torch.sum(self.values)
        lin = self._linear(rest)
        n = 1
        for i in rest:
            n *= self.shape[i]
        out = self.values.new_zeros(n).index_add_(0, lin, self.values)
        return out.reshape(tuple(self.shape[i] for i in rest))

    def num_non_zero_by_row(self) -> torch.Tensor:
        """Stored entries a row (int32)."""
        rows = self.indices[0]
        return torch.zeros(self.shape[0], dtype=rows.dtype,
                           device=self.device).index_add_(
            0, rows.long(), torch.ones_like(rows))

    numNonZeroByRow = num_non_zero_by_row

    def cast(self, dtype) -> "SparseTensor":
        return SparseTensor(self.indices, self.values.to(dtype), self.shape)

    def apply_fun(self, func) -> "SparseTensor":
        """Elementwise map over the stored values only (the function is
        not applied to the implicit zeros)."""
        return SparseTensor(self.indices, func(self.values), self.shape)

    applyFun = apply_fun
    apply1 = apply_fun

    def get(self, *indexes) -> float:
        """1-based element access: the stored value at the coordinate, or
        0 for an implicit zero."""
        if len(indexes) != self.dim():
            raise ValueError(f"need {self.dim()} indexes")
        hit = torch.ones(self.nnz(), dtype=torch.bool, device=self.device)
        for d, ix in enumerate(indexes):
            hit &= self.indices[d] == (int(ix) - 1)
        return float(self.values[hit].sum()) if bool(hit.any()) else 0.0

    def resize(self, shape: Sequence[int], nnz: Optional[int] = None
               ) -> "SparseTensor":
        """Re-shape the index space in place; with `nnz`, re-allocate the
        storage to that many (zeroed) entries. Shrinking drops the entries
        whose coordinates fall outside the new bounds."""
        self.shape = tuple(int(s) for s in shape)
        dev = self.device
        if nnz is not None and nnz != self.nnz():
            self.indices = tuple(torch.zeros(nnz, dtype=torch.int32,
                                             device=dev)
                                 for _ in self.shape)
            self.values = self.values.new_zeros(nnz)
        elif len(self.indices) != len(self.shape):
            self.indices = tuple(torch.zeros(self.nnz(), dtype=torch.int32,
                                             device=dev)
                                 for _ in self.shape)
        elif self.nnz():
            keep = torch.ones(self.nnz(), dtype=torch.bool, device=dev)
            for d, ix in enumerate(self.indices):
                keep &= ix < self.shape[d]
            if not bool(keep.all()):
                self.indices = tuple(ix[keep] for ix in self.indices)
                self.values = self.values[keep]
        return self

    def set_(self, other: "SparseTensor") -> "SparseTensor":
        """Adopt `other`'s storage (the reference's `set`)."""
        self.indices = other.indices
        self.values = other.values
        self.shape = other.shape
        return self

    def copy_(self, other: "SparseTensor") -> "SparseTensor":
        """Copy `other`'s entries into this tensor (the reference's
        `copy`)."""
        dev = self.device
        self.indices = tuple(ix.to(dev, torch.int32, copy=True)
                             for ix in other.indices)
        self.values = other.values.to(dev, copy=True)
        return self

    def __eq__(self, other):
        if not isinstance(other, SparseTensor):
            return NotImplemented
        return (self.shape == other.shape
                and len(self.indices) == len(other.indices)
                and all(torch.equal(a, b)
                        for a, b in zip(self.indices, other.indices))
                and torch.equal(self.values, other.values))

    # a mutable container (resize/set_ rebind the storage): unhashable
    __hash__ = None

    def __mul__(self, scalar):
        return SparseTensor(self.indices, self.values * scalar, self.shape)

    __rmul__ = __mul__

    def __truediv__(self, scalar):
        return SparseTensor(self.indices, self.values / scalar, self.shape)

    def __repr__(self):
        return (f"SparseTensor(shape={list(self.shape)}, nnz={self.nnz()}, "
                f"dtype={self.values.dtype})")


class SparseTensorMath:
    """Module-level products (the reference's `SparseTensorMath`): each
    dispatches on which operand is sparse."""

    @staticmethod
    def vdot(dense_vec, sparse: SparseTensor):
        return sparse.dot(dense_vec)

    @staticmethod
    def addmv(beta: float, t, alpha: float, mat: SparseTensor, vec
              ) -> torch.Tensor:
        """beta * t + alpha * (sparse mat @ dense vec)."""
        return mat.addmv(vec, beta=beta, alpha=alpha, out=t)

    @staticmethod
    def addmm(beta: float, mat3, alpha: float, mat1, mat2) -> torch.Tensor:
        """beta * mat3 + alpha * (mat1 @ mat2) with either operand sparse
        (sparse x dense, or dense x sparse)."""
        if isinstance(mat1, SparseTensor):
            return mat1.addmm(mat2, beta=beta, alpha=alpha, out=mat3)
        if not isinstance(mat2, SparseTensor):
            raise TypeError("one of mat1/mat2 must be a SparseTensor")
        if mat2.dim() != 2:
            raise ValueError("addmm needs a 2-D sparse tensor")
        dense = _as_tensor(mat1, mat2.device)
        if dense.ndim != 2 or dense.shape[1] != mat2.shape[0]:
            raise ValueError(
                f"dense {tuple(dense.shape)} incompatible with sparse "
                f"{mat2.shape}")
        # dense [M, K] x sparse [K, N]: entry (r, c, v) adds v * dense[:, r]
        # into the output's column c
        contrib = mat2.values[:, None] * dense[:, mat2._long(0)].T  # [nnz, M]
        prod = contrib.new_zeros((mat2.shape[1], dense.shape[0])).index_add_(
            0, mat2._long(1), contrib).T
        if mat3 is not None and beta != 0.0:
            return beta * _as_tensor(mat3, mat2.device) + alpha * prod
        return alpha * prod
