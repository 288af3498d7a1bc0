"""Data (counterpart of `bigdl_tpu.dataset`): `Sample`, `MiniBatch`,
`PaddingParam`, `LocalDataSet`, `DistributedDataSet` (one rank's shard),
`DataSet.array` and `DataSet.from_arrays`, the transformers
(`Transformer`, `FuncTransformer`, `chain`) and `SampleToMiniBatch`."""

from bigdl_tpu_torch.dataset.dataset import (AbstractDataSet, DataSet,
                                             DistributedDataSet,
                                             LocalDataSet)
from bigdl_tpu_torch.dataset.sample import MiniBatch, PaddingParam, Sample
from bigdl_tpu_torch.dataset.transformer import (FuncTransformer,
                                                 SampleToMiniBatch,
                                                 Transformer, chain)

__all__ = ["AbstractDataSet", "DataSet", "DistributedDataSet",
           "FuncTransformer", "LocalDataSet",
           "MiniBatch", "PaddingParam", "Sample", "SampleToMiniBatch",
           "Transformer", "chain"]
