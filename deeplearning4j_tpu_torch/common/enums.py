"""Core enums, copied from deeplearning4j_tpu/common/enums.py.

Only the enums the ported configurations carry are kept. Their string
values are the JAX package's, so a configuration JSON written by
either package parses in the other.
"""
from __future__ import annotations

import enum


class Activation(str, enum.Enum):
    IDENTITY = "identity"
    RELU = "relu"
    RELU6 = "relu6"
    LEAKYRELU = "leakyrelu"
    TANH = "tanh"
    SIGMOID = "sigmoid"
    HARDSIGMOID = "hardsigmoid"
    HARDTANH = "hardtanh"
    SOFTMAX = "softmax"
    SOFTPLUS = "softplus"
    SOFTSIGN = "softsign"
    ELU = "elu"
    SELU = "selu"
    GELU = "gelu"
    SWISH = "swish"
    CUBE = "cube"
    RATIONALTANH = "rationaltanh"
    RECTIFIEDTANH = "rectifiedtanh"


class WeightInit(str, enum.Enum):
    ZERO = "zero"
    ONES = "ones"
    SIGMOID_UNIFORM = "sigmoid_uniform"
    NORMAL = "normal"
    LECUN_NORMAL = "lecun_normal"
    LECUN_UNIFORM = "lecun_uniform"
    UNIFORM = "uniform"
    XAVIER = "xavier"
    XAVIER_UNIFORM = "xavier_uniform"
    XAVIER_FAN_IN = "xavier_fan_in"
    XAVIER_LEGACY = "xavier_legacy"
    RELU = "relu"
    RELU_UNIFORM = "relu_uniform"
    IDENTITY = "identity"
    VAR_SCALING_NORMAL_FAN_IN = "var_scaling_normal_fan_in"
    VAR_SCALING_NORMAL_FAN_OUT = "var_scaling_normal_fan_out"
    VAR_SCALING_NORMAL_FAN_AVG = "var_scaling_normal_fan_avg"
    VAR_SCALING_UNIFORM_FAN_IN = "var_scaling_uniform_fan_in"
    VAR_SCALING_UNIFORM_FAN_OUT = "var_scaling_uniform_fan_out"
    VAR_SCALING_UNIFORM_FAN_AVG = "var_scaling_uniform_fan_avg"
    DISTRIBUTION = "distribution"


class LossFunction(str, enum.Enum):
    MSE = "mse"
    L1 = "l1"
    L2 = "l2"
    MCXENT = "mcxent"
    XENT = "xent"
    NEGATIVELOGLIKELIHOOD = "negativeloglikelihood"
    SPARSE_MCXENT = "sparse_mcxent"
    HINGE = "hinge"
    SQUARED_HINGE = "squared_hinge"
    KL_DIVERGENCE = "kl_divergence"
    POISSON = "poisson"
    MEAN_ABSOLUTE_PERCENTAGE_ERROR = "mape"
    MEAN_SQUARED_LOGARITHMIC_ERROR = "msle"
    COSINE_PROXIMITY = "cosine_proximity"


class OptimizationAlgorithm(str, enum.Enum):
    STOCHASTIC_GRADIENT_DESCENT = "sgd"
    LINE_GRADIENT_DESCENT = "line_gradient_descent"
    CONJUGATE_GRADIENT = "conjugate_gradient"
    LBFGS = "lbfgs"


class BackpropType(str, enum.Enum):
    Standard = "standard"
    TruncatedBPTT = "truncated_bptt"


class ConvolutionMode(str, enum.Enum):
    Strict = "strict"
    Truncate = "truncate"
    Same = "same"


class PoolingType(str, enum.Enum):
    MAX = "max"
    AVG = "avg"
    SUM = "sum"
    PNORM = "pnorm"


class GradientNormalization(str, enum.Enum):
    NoNormalization = "none"
    RenormalizeL2PerLayer = "renormalize_l2_per_layer"
    RenormalizeL2PerParamType = "renormalize_l2_per_param_type"
    ClipElementWiseAbsoluteValue = "clip_elementwise_absolute_value"
    ClipL2PerLayer = "clip_l2_per_layer"
    ClipL2PerParamType = "clip_l2_per_param_type"
