"""The initialisers the JAX package's layers draw from, as torch in-place
draws: flax ``lecun_normal()`` for dense kernels and ``Dense``'s zero bias.
The embedding tables' ``uniform(scale=0.05)`` is drawn in
``ops/embedding.py``."""
from __future__ import annotations

import math

import torch
from torch import nn

# sd of a standard normal truncated to [-2, 2]; flax divides by it so the
# truncated draw keeps the variance it asks for
TRUNC_SD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int) -> torch.Tensor:
    """Fill ``t`` as flax's ``lecun_normal()``: a normal of variance
    1/fan_in, truncated at two of its standard deviations and rescaled so
    the draw keeps that variance."""
    std = math.sqrt(1.0 / fan_in) / TRUNC_SD
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std)


def dense_init_(linear: nn.Linear) -> nn.Linear:
    """Initialise ``linear`` as a flax ``Dense``: the weight lecun-normal,
    the bias zero."""
    lecun_normal_(linear.weight, linear.in_features)
    if linear.bias is not None:
        with torch.no_grad():
            linear.bias.zero_()
    return linear
