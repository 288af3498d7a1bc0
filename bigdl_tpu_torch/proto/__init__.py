"""Wire schemas the port reads and writes without a protobuf package
(counterpart of `bigdl_tpu.proto`): `bigdl_model`, the model-file
messages of `protos/bigdl_model.proto`."""
