"""Size-bucketed gradient exchange planning (counterpart of
`bigdl_tpu/optim/bucketing.py`).

`GradientBucketPlan` splits the gradient tree into size-bounded buckets
in reverse-topological order (the output side first: its gradients are
the backward's first), as the reference's does. The reference's SPMD
step leaves bucketing to XLA's all-reduce combiner; the port's
data-parallel step issues its all-reduces itself, so every multi-rank
step reduces through a plan: each bucket is flattened into one
contiguous buffer and summed with one all-reduce
(`parallel.collectives.bucket_all_reduce_mean`). Summing per element
does not depend on how the elements are grouped, so every bucket size
gives bit-identical gradients at world size 2.

Port differences: a tree's dicts flatten in insertion order (a module's
`named_parameters()` is in build order), where JAX sorts their keys; and
a bucket also ends where the dtype changes, because it is concatenated.
The overlap of the buckets with the backward pass is not ported: the
port's step takes its gradients from one `torch.autograd.grad` call.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple


def _flatten(tree) -> Tuple[list, Any]:
    """(leaves, structure) of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        leaves, spec = [], []
        for k, v in tree.items():
            sub, s = _flatten(v)
            leaves += sub
            spec.append((k, s, len(sub)))
        return leaves, ("dict", spec)
    if isinstance(tree, (list, tuple)):
        leaves, spec = [], []
        for v in tree:
            sub, s = _flatten(v)
            leaves += sub
            spec.append((None, s, len(sub)))
        return leaves, (type(tree), spec)
    return [tree], None


def _unflatten(structure, leaves: list):
    if structure is None:
        return leaves[0]
    kind, spec = structure
    out, i = [], 0
    for k, s, n in spec:
        out.append((k, _unflatten(s, leaves[i:i + n])))
        i += n
    if kind == "dict":
        return dict(out)
    return kind(v for _, v in out)


def _nbytes(leaf) -> int:
    if hasattr(leaf, "numel"):
        return leaf.numel() * leaf.element_size()
    return 0


class GradientBucketPlan:
    """Reverse-topological, size-bounded bucketing of a gradient tree,
    built once a run from the parameter tree; `split` gives a same-shaped
    tree's leaves per bucket, `join` puts them back."""

    def __init__(self, params_tree: Any, bucket_bytes: int = 4 * 2 ** 20):
        leaves, self._structure = _flatten(params_tree)
        self.n_leaves = len(leaves)
        self.bucket_bytes = int(bucket_bytes)
        sizes = [_nbytes(leaf) for leaf in leaves]
        dtypes = [getattr(leaf, "dtype", None) for leaf in leaves]
        self.buckets: List[Tuple[int, ...]] = []
        cur: List[int] = []
        cur_bytes = 0
        for i in reversed(range(self.n_leaves)):
            if cur and (cur_bytes + sizes[i] > self.bucket_bytes
                        or dtypes[i] != dtypes[cur[0]]):
                self.buckets.append(tuple(cur))
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += sizes[i]
        if cur:
            self.buckets.append(tuple(cur))
        #: distinct bucket layouts (each leaf's shape and dtype)
        self.layouts = sorted({
            tuple((tuple(leaves[i].shape), str(leaves[i].dtype)) for i in b)
            for b in self.buckets})
        self.total_bytes = sum(sizes)

    def __len__(self) -> int:
        return len(self.buckets)

    def split(self, tree: Any) -> List[Tuple]:
        """Per-bucket leaf tuples of a tree with the plan's structure."""
        leaves = _flatten(tree)[0]
        if len(leaves) != self.n_leaves:
            raise ValueError(f"tree has {len(leaves)} leaves; plan was "
                             f"built for {self.n_leaves}")
        return [tuple(leaves[i] for i in b) for b in self.buckets]

    def join(self, bucket_leaves: Sequence[Sequence]) -> Any:
        """Inverse of `split`: reassemble the full tree."""
        flat: List = [None] * self.n_leaves
        for b, vals in zip(self.buckets, bucket_leaves):
            for i, v in zip(b, vals):
                flat[i] = v
        return _unflatten(self._structure, flat)

    def describe(self) -> dict:
        """A summary of the plan."""
        return {"n_buckets": len(self.buckets),
                "n_layouts": len(self.layouts),
                "bucket_bytes": self.bucket_bytes,
                "total_bytes": self.total_bytes}
