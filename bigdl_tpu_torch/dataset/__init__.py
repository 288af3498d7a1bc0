"""Data (counterpart of `bigdl_tpu.dataset`): `MiniBatch` and
`LocalDataSet`."""

from bigdl_tpu_torch.dataset.dataset import LocalDataSet
from bigdl_tpu_torch.dataset.sample import MiniBatch

__all__ = ["LocalDataSet", "MiniBatch"]
