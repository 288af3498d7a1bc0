"""Carrying weights between the JAX package and the port."""

from bigdl_tpu_torch.interop.jax_params import (lm_params_tree,
                                                load_module_params,
                                                load_transformer_lm_params,
                                                module_params_tree,
                                                module_state)

__all__ = ["lm_params_tree", "load_module_params",
           "load_transformer_lm_params", "module_params_tree",
           "module_state"]
