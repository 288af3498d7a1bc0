"""Models (counterpart of `bigdl_tpu.models`): `TransformerLM`."""

from bigdl_tpu_torch.models.transformer import TransformerLM

__all__ = ["TransformerLM"]
