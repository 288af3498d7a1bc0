"""Ops with hand-written kernels (attention, the fused BN+ReLU tail) and
the kernels' build helper (counterpart of `bigdl_tpu.ops`)."""
