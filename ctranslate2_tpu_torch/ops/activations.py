"""Activation functions.

Enum order matches the reference's serialized ActivationType ids
(reference: include/ctranslate2/ops/activation.h:9-17):
  0=ReLU 1=GELUTanh 2=Swish 3=GELU 4=GELUSigmoid 5=Tanh 6=Sigmoid
"""

from __future__ import annotations

import torch

_SQRT_2_OVER_PI = 0.7978845608028654


def relu(x):
    return torch.relu(x)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * x * x * x)))


def swish(x):
    return x * torch.sigmoid(x)


def gelu(x):
    # Exact erf-based GELU.
    return torch.nn.functional.gelu(x)


def gelu_sigmoid(x):
    return x * torch.sigmoid(1.702 * x)


def tanh(x):
    return torch.tanh(x)


def sigmoid(x):
    return torch.sigmoid(x)


ACTIVATIONS = (relu, gelu_tanh, swish, gelu, gelu_sigmoid, tanh, sigmoid)
ACTIVATION_NAMES = ("relu", "gelu_tanh", "swish", "gelu", "gelu_sigmoid", "tanh", "sigmoid")


def get_activation(index_or_name):
    if isinstance(index_or_name, str):
        return ACTIVATIONS[ACTIVATION_NAMES.index(index_or_name)]
    return ACTIVATIONS[int(index_or_name)]
