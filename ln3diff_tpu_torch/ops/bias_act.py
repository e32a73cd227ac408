"""Bias + activation (+ gain, + clamp): the reference's fused CUDA op
``utils/torch_utils/ops/bias_act.py:112-290`` as plain PyTorch.

Port of ``ln3diff_tpu/ops/bias_act.py``: the same activations with their
default gains, the bias broadcast along one axis (channels-last by
default, as in the JAX function).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

# (fn, default gain) per activation, the reference's activation_funcs
ACTIVATIONS = {
    'linear': (lambda x: x, 1.0),
    'relu': (F.relu, math.sqrt(2)),
    'lrelu': (lambda x: F.leaky_relu(x, 0.2), math.sqrt(2)),
    'tanh': (torch.tanh, 1.0),
    'sigmoid': (torch.sigmoid, 1.0),
    'elu': (F.elu, 1.0),
    'selu': (F.selu, 1.0),
    'softplus': (F.softplus, 1.0),
    'swish': (F.silu, math.sqrt(2)),
}


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None,
             act: str = 'linear', gain: Optional[float] = None,
             clamp: Optional[float] = None, dim: int = -1) -> torch.Tensor:
    """y = clamp(gain · act(x + b)), ``b`` broadcast along ``dim``; the
    gain defaults to the activation's, a negative or None clamp is off."""
    fn, def_gain = ACTIVATIONS[act]
    if b is not None:
        shape = [1] * x.ndim
        shape[dim] = -1
        x = x + b.reshape(shape).to(x.dtype)
    x = fn(x)
    g = def_gain if gain is None else gain
    if g != 1.0:
        x = x * g
    if clamp is not None and clamp >= 0:
        x = x.clamp(-clamp, clamp)
    return x
