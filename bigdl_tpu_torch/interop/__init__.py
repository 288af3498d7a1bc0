"""Carrying weights from the JAX package into the port."""

from bigdl_tpu_torch.interop.jax_params import load_transformer_lm_params

__all__ = ["load_transformer_lm_params"]
