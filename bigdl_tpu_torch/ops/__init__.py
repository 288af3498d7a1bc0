"""Attention ops and the kernels' build helper (counterpart of
`bigdl_tpu.ops`)."""
