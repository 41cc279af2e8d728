"""LSTM and GRU cell primitives (port of e2e_asr_tpu/core/cells.py).

tf BasicLSTMCell semantics: one matmul of concat([x, h]) with a
[in+H, 4H] kernel, gate order **i, j, f, o**, and forget bias **+1.0**
added to f before the sigmoid (the bias parameter itself is zero-init).
The recurrent paths split the kernel into W_x = kernel[:in] (applied to all
time steps at once, `lstm_precompute_inputs`) and W_h = kernel[in:].
The GRU cell is TF-1's GRUCell (below), split the same way.
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


# ---------------------------------------------------------------------------
# GRU (TF-1 GRUCell): a gates kernel [in+H, 2H] split r | u with bias init
# 1.0, and a candidate kernel [in+H, H] that consumes r * h.
# ---------------------------------------------------------------------------

def gru_init(gen: torch.Generator, in_dim: int, hidden: int, *,
             init=glorot_uniform, device=None) -> dict:
    return {
        "gates": {"kernel": init(gen, (in_dim + hidden, 2 * hidden),
                                 device=device),
                  "bias": torch.ones(2 * hidden, device=device)},
        "candidate": {"kernel": init(gen, (in_dim + hidden, hidden),
                                     device=device),
                      "bias": torch.zeros(hidden, device=device)},
    }


def gru_zero_state(batch_shape, hidden: int, *, device=None) -> torch.Tensor:
    return torch.zeros(tuple(batch_shape) + (hidden,), device=device)


def gru_precompute_inputs(params: dict, x_seq: torch.Tensor, in_dim: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The input contributions of all time steps, one matmul each:
    (gates_x [T,B,2H] = x@W_gx + b_g, cand_x [T,B,H] = x@W_cx + b_c)."""
    return (x_seq @ params["gates"]["kernel"][:in_dim]
            + params["gates"]["bias"],
            x_seq @ params["candidate"]["kernel"][:in_dim]
            + params["candidate"]["bias"])


def gru_split_step(gx: torch.Tensor, cx: torch.Tensor, h: torch.Tensor,
                   w_gh: torch.Tensor, w_ch: torch.Tensor) -> torch.Tensor:
    """One GRU step over precomputed input contributions: value =
    sigmoid(gx + h@W_gh) split r | u, c = tanh(cx + (r*h)@W_ch), returns
    h' = u*h + (1-u)*c."""
    hidden = h.shape[-1]
    value = torch.sigmoid(gx + h @ w_gh)
    r, u = value[..., :hidden], value[..., hidden:]
    c = torch.tanh(cx + (r * h) @ w_ch)
    return u * h + (1.0 - u) * c


def gru_step(params: dict, x: torch.Tensor, h: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One GRU step: returns (output, new h), the two equal."""
    xh = torch.cat([x, h], dim=-1)
    value = torch.sigmoid(xh @ params["gates"]["kernel"]
                          + params["gates"]["bias"])
    r, u = torch.split(value, h.shape[-1], dim=-1)
    xrh = torch.cat([x, r * h], dim=-1)
    c = torch.tanh(xrh @ params["candidate"]["kernel"]
                   + params["candidate"]["bias"])
    new_h = u * h + (1.0 - u) * c
    return new_h, new_h
