"""LSTM cell primitives (port of the LSTM half of e2e_asr_tpu/core/cells.py).

tf BasicLSTMCell semantics: one matmul of concat([x, h]) with a
[in+H, 4H] kernel, gate order **i, j, f, o**, and forget bias **+1.0**
added to f before the sigmoid (the bias parameter itself is zero-init).
The recurrent paths split the kernel into W_x = kernel[:in] (applied to all
time steps at once, `lstm_precompute_inputs`) and W_h = kernel[in:].
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from e2e_asr_tpu_torch.core.layers import glorot_uniform


class LSTMState(NamedTuple):
    c: torch.Tensor
    h: torch.Tensor


def lstm_init(gen: torch.Generator, in_dim: int, hidden: int, *,
              init=glorot_uniform, device=None) -> dict:
    return {"kernel": init(gen, (in_dim + hidden, 4 * hidden), device=device),
            "bias": torch.zeros(4 * hidden, device=device)}


def lstm_zero_state(batch_shape, hidden: int, *, device=None) -> LSTMState:
    shape = tuple(batch_shape) + (hidden,)
    return LSTMState(torch.zeros(shape, device=device),
                     torch.zeros(shape, device=device))


def _lstm_apply_gates(gates: torch.Tensor, c: torch.Tensor, hidden: int
                      ) -> tuple[torch.Tensor, LSTMState]:
    i, j, f, o = torch.split(gates, hidden, dim=-1)
    new_c = c * torch.sigmoid(f + 1.0) + torch.sigmoid(i) * torch.tanh(j)
    new_h = torch.sigmoid(o) * torch.tanh(new_c)
    return new_h, LSTMState(new_c, new_h)


def lstm_step(params: dict, x: torch.Tensor, state: LSTMState
              ) -> tuple[torch.Tensor, LSTMState]:
    """One LSTM step: returns (output h, new state). x: [..., in_dim]."""
    xh = torch.cat([x, state.h], dim=-1)
    gates = xh @ params["kernel"] + params["bias"]
    return _lstm_apply_gates(gates, state.c, state.h.shape[-1])


def lstm_precompute_inputs(params: dict, x_seq: torch.Tensor, in_dim: int
                           ) -> torch.Tensor:
    """x@W_x + bias for all time steps in one matmul: [T,B,in] -> [T,B,4H]."""
    return x_seq @ params["kernel"][:in_dim] + params["bias"]
