"""TensorBoard summaries (counterpart of `bigdl_tpu.visualization`), with
no protobuf package: `wire` encodes the few messages by hand."""

from bigdl_tpu_torch.visualization.record_writer import (RecordWriter,
                                                         TFRecordFileWriter)
from bigdl_tpu_torch.visualization.event_writer import EventWriter
from bigdl_tpu_torch.visualization.graph_writer import (model_graph_def,
                                                        save_graph_topology)
from bigdl_tpu_torch.visualization.summary import (FileReader, Summary,
                                                   TrainSummary,
                                                   ValidationSummary,
                                                   histogram_event,
                                                   scalar_event)

__all__ = ["RecordWriter", "TFRecordFileWriter", "EventWriter", "FileReader",
           "Summary", "TrainSummary", "ValidationSummary", "scalar_event",
           "histogram_event", "model_graph_def", "save_graph_topology"]
