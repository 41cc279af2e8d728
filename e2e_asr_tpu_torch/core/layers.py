"""Parameter initializers and the dense layer (port of
e2e_asr_tpu/core/layers.py).

Initialization policy mirrors the reference:
- encoder LSTM kernels: U(-0.075, 0.075)   (models/encoder.py)
- decoder embedding: U(-1, 1)
- all decoder / projection / attention kernels: glorot_uniform, biases zero.

Random numbers are drawn on the CPU from an explicit torch.Generator and
then moved to `device`, so one seed gives the same weights on every device.
"""
from __future__ import annotations

import math

import torch


def uniform_init(gen: torch.Generator, shape, scale: float, *,
                 device=None) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32)
    return ((u * 2.0 - 1.0) * scale).to(device)


def glorot_uniform(gen: torch.Generator, shape, *,
                   device=None) -> torch.Tensor:
    """TF-1 glorot_uniform_initializer: limit sqrt(6 / (fan_in + fan_out))."""
    fan_in, fan_out = (shape[0], shape[0]) if len(shape) == 1 else shape
    return uniform_init(gen, shape, math.sqrt(6.0 / (fan_in + fan_out)),
                        device=device)


def dense_params(gen: torch.Generator, in_dim: int, out_dim: int, *,
                 init=glorot_uniform, device=None) -> dict:
    return {"kernel": init(gen, (in_dim, out_dim), device=device),
            "bias": torch.zeros(out_dim, device=device)}


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    """y = x @ kernel + bias."""
    return x @ params["kernel"] + params["bias"]
