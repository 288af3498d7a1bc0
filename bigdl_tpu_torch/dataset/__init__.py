"""Data (counterpart of `bigdl_tpu.dataset`): `Sample`, `MiniBatch`,
`PaddingParam`, `LocalDataSet`, `DistributedDataSet` (one rank's shard),
`DataSet.array` and `DataSet.from_arrays`, the transformers
(`Transformer`, `FuncTransformer`, `chain`), `SampleToMiniBatch`, and the
prefetching input pipeline (`ThreadedPrefetcher`, `InputPipeline`,
`build_input_pipeline`, `split_elementwise_prefix`)."""

from bigdl_tpu_torch.dataset.dataset import (AbstractDataSet, DataSet,
                                             DistributedDataSet,
                                             LocalDataSet)
from bigdl_tpu_torch.dataset.prefetch import (InputPipeline,
                                              ThreadedPrefetcher,
                                              build_input_pipeline,
                                              split_elementwise_prefix)
from bigdl_tpu_torch.dataset.sample import MiniBatch, PaddingParam, Sample
from bigdl_tpu_torch.dataset.transformer import (FuncTransformer,
                                                 SampleToMiniBatch,
                                                 Transformer, chain)

__all__ = ["AbstractDataSet", "DataSet", "DistributedDataSet",
           "FuncTransformer", "InputPipeline", "LocalDataSet",
           "MiniBatch", "PaddingParam", "Sample", "SampleToMiniBatch",
           "ThreadedPrefetcher", "Transformer", "build_input_pipeline",
           "chain", "split_elementwise_prefix"]
