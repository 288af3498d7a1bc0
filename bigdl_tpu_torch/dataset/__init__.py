"""Data (counterpart of `bigdl_tpu.dataset`): `Sample`, `MiniBatch`,
`LocalDataSet`, `DataSet.from_arrays` and `SampleToMiniBatch`."""

from bigdl_tpu_torch.dataset.dataset import (AbstractDataSet, DataSet,
                                             LocalDataSet)
from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample
from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch

__all__ = ["AbstractDataSet", "DataSet", "LocalDataSet", "MiniBatch",
           "Sample", "SampleToMiniBatch"]
