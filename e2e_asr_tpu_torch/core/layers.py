"""Parameter initializers, the dense layer, dropout, and the transformer
encoder's layer norm and GELU (port of e2e_asr_tpu/core/layers.py and of
`_layer_norm` in e2e_asr_tpu/models/transformer_encoder.py).

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


def dropout_mask(gen: torch.Generator, shape, keep_prob: float,
                 device) -> torch.Tensor:
    """Bool keep-mask of `shape`, True with probability keep_prob, drawn on
    the generator's device and moved to `device`."""
    u = torch.rand(tuple(shape), generator=gen, device=gen.device)
    return (u < keep_prob).to(device)


def dropout(x: torch.Tensor, keep_prob: float, *, gen=None,
            mask=None) -> torch.Tensor:
    """Inverted dropout as tf.nn.dropout: kept values scaled by 1/keep_prob.
    The keep-mask is handed in (bool, x's shape) or drawn from `gen`."""
    if keep_prob >= 1.0:
        return x
    if mask is None:
        mask = dropout_mask(gen, x.shape, keep_prob, x.device)
    return torch.where(mask, x / keep_prob, torch.zeros_like(x))


def layer_norm(params: dict, x: torch.Tensor, eps: float = 1e-6
               ) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * scale + bias over the last axis, with
    the biased variance (transformer_encoder._layer_norm)."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default, the tanh approximation (torch's default is the
    exact erf form)."""
    return torch.nn.functional.gelu(x, approximate="tanh")
