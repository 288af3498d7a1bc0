"""Carrying weights between the JAX package and the port."""

from bigdl_tpu_torch.interop.jax_params import (gpipe_params_tree,
                                                lm_params_tree,
                                                load_gpipe_params,
                                                load_module_params,
                                                load_params,
                                                load_pipeline_params,
                                                load_transformer_lm_params,
                                                module_params_tree,
                                                module_state,
                                                named_from_tree,
                                                params_tree,
                                                pipeline_params_tree,
                                                tree_from_named)

__all__ = ["gpipe_params_tree", "lm_params_tree", "load_gpipe_params",
           "load_module_params", "load_params", "load_pipeline_params",
           "load_transformer_lm_params", "module_params_tree",
           "module_state", "named_from_tree", "params_tree",
           "pipeline_params_tree", "tree_from_named"]
