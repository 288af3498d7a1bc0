"""Feature-column ops for tabular and recommender pipelines (counterpart
of `bigdl_tpu/ops/feature_col.py`): `BucketizedCol`,
`CategoricalColHashBucket`, `CategoricalColVocaList`, `CrossCol`,
`IndicatorCol`, `Kv2Tensor`, `MkString`, `Substr`.

They turn raw features (strings, ids, numbers) into numeric tensors. The
string work runs on numpy arrays on the host, as in the reference (the
training loop leaves string and bytes columns there); the numeric
outputs are tensors on the op's `device` (keyword-only; default the
card), and the string outputs (`MkString`, `Substr`) stay numpy object
arrays. Hashing is `zlib.crc32`, as in the reference, so a string falls
in the same bucket in both packages and in every process (Python's
`hash` is salted per process).
"""

from __future__ import annotations

import zlib
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch._device import resolve_device
from bigdl_tpu_torch.ops.operation import Operation


def _stable_hash(s: str, buckets: int) -> int:
    return zlib.crc32(str(s).encode("utf-8")) % buckets


def _host(x) -> np.ndarray:
    """A column as a numpy array (a tensor fetched from its device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class _NumericOp(Operation):
    """An op whose output is a tensor on `self.device`."""

    def __init__(self, name: Optional[str] = None, *, device=None):
        super().__init__(name)
        self.device = resolve_device(device)

    def _out(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)


class BucketizedCol(_NumericOp):
    """Bucketize numeric features by sorted `boundaries`: each output is
    the count of boundaries at or below the value (int32).

    Example:
        >>> from bigdl_tpu_torch.ops.feature_col import BucketizedCol
        >>> col = BucketizedCol([0.0, 10.0, 100.0], device="cpu")
        >>> col([[-1.0, 15.0], [5.0, 200.0]]).tolist()
        [[0, 2], [1, 3]]
    """

    def __init__(self, boundaries: Sequence[float],
                 name: Optional[str] = None, *, device=None):
        super().__init__(name, device=device)
        self.boundaries = torch.tensor(sorted(boundaries),
                                       dtype=torch.float32,
                                       device=self.device)

    def forward(self, input):
        x = torch.as_tensor(input, device=self.device)
        if x.dtype == torch.float64:  # the reference's arrays are f32
            x = x.float()
        return torch.sum(x[..., None] >= self.boundaries,
                         dim=-1).to(torch.int32)


class CategoricalColHashBucket(_NumericOp):
    """A string or id column -> its hash bucket in [0, hash_bucket_size)
    (int32)."""

    def __init__(self, hash_bucket_size: int, name: Optional[str] = None,
                 *, device=None):
        super().__init__(name, device=device)
        self.size = hash_bucket_size

    def forward(self, input):
        arr = _host(input)
        return self._out(np.vectorize(lambda s: _stable_hash(s, self.size),
                                      otypes=[np.int32])(arr))


class CategoricalColVocaList(_NumericOp):
    """A string column -> its index in `vocab` (int32). An unknown string
    maps to `default_value`, or with `num_oov_buckets` > 0 hashes into
    one of that many buckets past the vocabulary.

    Example:
        >>> import numpy as np
        >>> from bigdl_tpu_torch.ops.feature_col import CategoricalColVocaList
        >>> col = CategoricalColVocaList(["cat", "dog"], default_value=-1,
        ...                              device="cpu")
        >>> col(np.array(["dog", "cat", "fish"])).tolist()
        [1, 0, -1]
    """

    def __init__(self, vocab: Sequence[str], default_value: int = -1,
                 num_oov_buckets: int = 0, name: Optional[str] = None, *,
                 device=None):
        super().__init__(name, device=device)
        self.lookup = {v: i for i, v in enumerate(vocab)}
        self.vocab_size = len(self.lookup)
        self.default = default_value
        self.oov = num_oov_buckets

    def _map(self, s):
        if s in self.lookup:
            return self.lookup[s]
        if self.oov > 0:
            return self.vocab_size + _stable_hash(s, self.oov)
        return self.default

    def forward(self, input):
        return self._out(np.vectorize(self._map, otypes=[np.int32])(
            _host(input)))


class CrossCol(_NumericOp):
    """Crosses N categorical columns (a `Table` of N columns of one shape)
    into one hashed feature: each row's values joined by "_X_", hashed
    into [0, hash_bucket_size) (int32)."""

    def __init__(self, hash_bucket_size: int, name: Optional[str] = None,
                 *, device=None):
        super().__init__(name, device=device)
        self.size = hash_bucket_size

    def forward(self, input):
        cols = [_host(input[i + 1]) for i in range(len(input))]
        flat = [c.reshape(-1) for c in cols]
        res = np.asarray([_stable_hash("_X_".join(str(v[i]) for v in flat),
                                       self.size)
                          for i in range(flat[0].shape[0])], np.int32)
        return self._out(res.reshape(cols[0].shape))


class IndicatorCol(_NumericOp):
    """Categorical ids [..., K] -> multi-hot counts [..., feat_len] (f32):
    the one-hot rows of the K ids summed, clipped to 1 unless `is_count`.
    A negative or out-of-range id gives a zero row, as the reference's
    `jax.nn.one_hot` does (`F.one_hot` would raise)."""

    def __init__(self, feat_len: int, is_count: bool = True,
                 name: Optional[str] = None, *, device=None):
        super().__init__(name, device=device)
        self.feat_len = feat_len
        self.is_count = is_count

    def forward(self, input):
        idx = torch.as_tensor(input, device=self.device).to(torch.int32)
        valid = (idx >= 0) & (idx < self.feat_len)
        hot = F.one_hot(idx.clamp(0, self.feat_len - 1).long(),
                        self.feat_len) * valid[..., None]
        counts = torch.sum(hot.to(torch.float32), dim=-2)
        return counts if self.is_count else torch.clamp(counts, 0.0, 1.0)


class Kv2Tensor(_NumericOp):
    """Parses "k:v,k:v" strings into dense f32 rows of `feat_len` (host
    parsing, as in the reference)."""

    def __init__(self, kv_delimiter: str = ",", item_delimiter: str = ":",
                 feat_len: int = 0, name: Optional[str] = None, *,
                 device=None):
        super().__init__(name, device=device)
        self.kv_delimiter = kv_delimiter
        self.item_delimiter = item_delimiter
        self.feat_len = feat_len

    def forward(self, input):
        arr = _host(input).reshape(-1)
        out = np.zeros((arr.shape[0], self.feat_len), np.float32)
        for r, s in enumerate(arr):
            for item in str(s).split(self.kv_delimiter):
                if not item:
                    continue
                k, v = item.split(self.item_delimiter)
                out[r, int(k)] = float(v)
        return self._out(out)


class MkString(Operation):
    """Joins each row's elements into one string (a numpy object array
    on the host)."""

    def __init__(self, str_delimiter: str = ",",
                 name: Optional[str] = None):
        super().__init__(name)
        self.delim = str_delimiter

    def forward(self, input):
        arr = _host(input)
        return np.asarray([self.delim.join(str(v) for v in row)
                           for row in arr.reshape(arr.shape[0], -1)], object)


class Substr(Operation):
    """The substring (or sub-bytes) at `pos` of `length` (-1: to the end)
    of each element (a numpy object array on the host)."""

    def __init__(self, pos: int = 0, length: int = -1,
                 name: Optional[str] = None):
        super().__init__(name)
        self.pos, self.length = pos, length

    def forward(self, input):
        end = None if self.length < 0 else self.pos + self.length

        def cut(s):
            if isinstance(s, (bytes, np.bytes_)):
                return bytes(s)[self.pos:end]
            return str(s)[self.pos:end]

        arr = _host(input)
        return np.asarray([cut(s) for s in arr.reshape(-1)],
                          object).reshape(arr.shape)
