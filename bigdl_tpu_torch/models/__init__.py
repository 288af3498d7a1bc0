"""Models (counterpart of `bigdl_tpu.models`): `TransformerLM` and the
ResNets."""

from bigdl_tpu_torch.models.resnet import ResNet, ResNet50
from bigdl_tpu_torch.models.transformer import TransformerLM

__all__ = ["ResNet", "ResNet50", "TransformerLM"]
