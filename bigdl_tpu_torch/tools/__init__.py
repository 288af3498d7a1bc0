"""Tools (counterpart of `bigdl_tpu.tools`): the training benchmark."""
