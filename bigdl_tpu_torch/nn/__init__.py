"""Layers (counterpart of `bigdl_tpu.nn`): the transformer, the ResNet,
the feed-forward model zoo's, the recurrent and the Wide&Deep paths, the
int8 quantized layers, the table containers, `Remat`, the static `Graph`
with its node DSL, the `DynamicGraph` with its control ops, the
`linear.py` family and the tree LSTMs."""

from bigdl_tpu_torch.nn.activation import LogSoftMax, ReLU, Sigmoid, Tanh
from bigdl_tpu_torch.nn.attention import (MultiHeadAttention,
                                          ScaledDotProductAttention,
                                          TransformerBlock, cache_commit,
                                          cache_write, rope)
from bigdl_tpu_torch.nn.containers import (
    BifurcateSplitTable, Bottle, CAddTable, CAveTable, CDivTable, CMaxTable,
    CMinTable, CMulTable, Concat, ConcatTable, Container, CSubTable, Echo,
    FlattenTable, Graph, Identity, Input, InputNode, JoinTable, MapTable,
    MixtureTable, NarrowTable, ParallelTable, Remat, SelectTable, Sequential,
    SplitTable, StaticGraph)
from bigdl_tpu_torch.nn.conv import (SpaceToDepthStemConvolution,
                                     SpatialConvolution,
                                     SpatialDilatedConvolution,
                                     SpatialShareConvolution)
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion, MSECriterion,
                                          TimeDistributedCriterion,
                                          TimeDistributedMaskCriterion)
from bigdl_tpu_torch.nn.dropout import Dropout, lend_generator
from bigdl_tpu_torch.nn.dynamic_graph import (
    DEAD, ControlOps, ControlTrigger, DynamicGraph, Enter, Exit, FrameManager,
    LoopCondOps, MergeOps, NextIteration, Scheduler, SwitchOps, switch_port)
from bigdl_tpu_torch.nn.embedding import (LookupTable, LookupTableSparse,
                                           SparseJoinTable, SparseLinear)
from bigdl_tpu_torch.nn.fusion import (fusible_activation, fusible_bn,
                                      fusion_enabled, fusion_scope, set_fusion)
from bigdl_tpu_torch.nn.initialization import (MsraFiller, RandomNormal,
                                               RandomUniform, Xavier, Zeros)
from bigdl_tpu_torch.nn.linear import (Add, AddConstant, Bilinear, CAdd,
                                      CMul, Cosine, Euclidean, Highway,
                                      Linear, Maxout, Mul, MulConstant,
                                      Scale)
from bigdl_tpu_torch.nn.module import (Activity, ApplyContext, Module, Node,
                                      functional_apply, merge_state,
                                      param_count, topo_sort)
from bigdl_tpu_torch.nn.normalization import (BatchNormalization,
                                              LayerNormalization,
                                              SpatialBatchNormalization)
from bigdl_tpu_torch.nn.pooling import (Pooler, SpatialAveragePooling,
                                        SpatialCrossMapLRN, SpatialMaxPooling)
from bigdl_tpu_torch.nn.quantized import (
    QuantizedLinear, QuantizedSpatialConvolution,
    QuantizedSpatialDilatedConvolution, Quantizer, WeightOnlyQuantizedLinear,
    WeightOnlyQuantizedSpatialConvolution)
from bigdl_tpu_torch.nn.recurrent import (
    GRU, LSTM, LSTM2, BiRecurrent, Cell, ConvLSTMPeephole,
    ConvLSTMPeephole3D, GRUCell, LSTMCell, LSTMPeephole, LSTMPeepholeCell,
    MultiRNNCell, Recurrent, RecurrentDecoder, RnnCell, TimeDistributed)
from bigdl_tpu_torch.nn.shape_ops import DenseToSparse, Mean, Reshape
from bigdl_tpu_torch.nn.tree import BinaryTreeLSTM, TreeLSTM

RNN = RnnCell  # the reference's alias (its model files name RnnCell "RNN")

__all__ = ["Activity", "ApplyContext", "BatchNormalization",
           "BifurcateSplitTable", "Bottle", "CAddTable", "CAveTable",
           "CDivTable", "CMaxTable", "CMinTable", "CMulTable", "CSubTable",
           "Cell", "ClassNLLCriterion",
           "Concat", "ConcatTable", "Container", "DenseToSparse", "Dropout",
           "Echo", "FlattenTable", "Graph", "Identity", "Input", "InputNode",
           "JoinTable", "MapTable", "MixtureTable", "NarrowTable", "Node",
           "ParallelTable", "SelectTable", "SplitTable", "StaticGraph",
           "functional_apply", "merge_state", "param_count", "topo_sort",
           "LSTM", "LSTM2", "LSTMCell", "LayerNormalization", "Linear",
           "LogSoftMax", "LookupTable", "LookupTableSparse", "MSECriterion",
           "Module",
           "MsraFiller", "MultiHeadAttention", "MultiRNNCell", "Pooler",
           "Mean", "QuantizedLinear", "QuantizedSpatialConvolution",
           "QuantizedSpatialDilatedConvolution", "Quantizer", "RNN",
           "RandomNormal", "RandomUniform", "ReLU", "Recurrent", "Remat",
           "Reshape",
           "RnnCell", "ScaledDotProductAttention", "Sequential", "Sigmoid",
           "SpaceToDepthStemConvolution", "SparseJoinTable", "SparseLinear",
           "SpatialAveragePooling",
           "SpatialBatchNormalization", "SpatialConvolution",
           "SpatialDilatedConvolution", "SpatialShareConvolution",
           "SpatialCrossMapLRN", "SpatialMaxPooling", "Tanh",
           "TimeDistributed", "TimeDistributedCriterion",
           "TimeDistributedMaskCriterion", "TransformerBlock",
           "WeightOnlyQuantizedLinear",
           "WeightOnlyQuantizedSpatialConvolution", "Xavier",
           "Zeros", "Add", "AddConstant", "Bilinear", "CAdd", "CMul",
           "Cosine", "Euclidean", "Highway", "Maxout", "Mul", "MulConstant",
           "Scale", "DEAD", "ControlOps", "ControlTrigger", "DynamicGraph",
           "Enter", "Exit", "FrameManager", "LoopCondOps", "MergeOps",
           "NextIteration", "Scheduler", "SwitchOps", "switch_port", "GRU",
           "GRUCell", "LSTMPeephole", "LSTMPeepholeCell", "ConvLSTMPeephole",
           "ConvLSTMPeephole3D", "BiRecurrent", "RecurrentDecoder",
           "TreeLSTM", "BinaryTreeLSTM", "cache_commit", "cache_write",
           "fusible_activation", "fusible_bn", "fusion_enabled",
           "fusion_scope", "lend_generator", "rope", "set_fusion"]
