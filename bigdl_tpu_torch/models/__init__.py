"""Models (counterpart of `bigdl_tpu.models`): `TransformerLM`, the ResNets,
the feed-forward zoo (LeNet-5 and its `Graph` form, Inception v1 and v2,
VGG, the autoencoder), the sequence models (`PTBModel`, `SimpleRNN`) and
the `WideAndDeep` recommender."""

from bigdl_tpu_torch.models.autoencoder import Autoencoder
from bigdl_tpu_torch.models.inception import (Inception_v1,
                                              Inception_v1_NoAuxClassifier,
                                              Inception_v2,
                                              Inception_v2_NoAuxClassifier,
                                              inception_layer_v2,
                                              inception_module)
from bigdl_tpu_torch.models.lenet import LeNet5, lenet_graph
from bigdl_tpu_torch.models.resnet import (ResNet, ResNet50, basic_block,
                                          bottleneck)
from bigdl_tpu_torch.models.rnn import PTBModel, SimpleRNN
from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.models.vgg import Vgg_16, Vgg_19, VggForCifar10
from bigdl_tpu_torch.models.widedeep import WideAndDeep

__all__ = ["Autoencoder", "Inception_v1", "Inception_v1_NoAuxClassifier",
           "Inception_v2", "Inception_v2_NoAuxClassifier", "LeNet5",
           "PTBModel", "ResNet", "ResNet50", "SimpleRNN", "TransformerLM",
           "Vgg_16", "Vgg_19", "VggForCifar10", "WideAndDeep",
           "basic_block", "bottleneck", "inception_layer_v2",
           "inception_module", "lenet_graph"]
