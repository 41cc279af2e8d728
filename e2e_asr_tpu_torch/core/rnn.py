"""Length-aware RNN layers over time (port of e2e_asr_tpu/core/rnn.py).

Semantics of tf.nn.(bidirectional_)dynamic_rnn, as in the reference:
- outputs at t >= seq_len are zeroed,
- the backward direction of a bidirectional layer sees each example
  reversed within its own length.

The bidirectional LSTM layer flips the whole sequence (padding then leads)
and runs both directions in one launch of kernel A
(kernels/lstm_bidir.py), whose backward direction carries its state
through the leading padding; that equals reversing within each length.
Gradients flow through the kernel's backward. Training dropout is applied
to the concatenated output outside the kernel, as the reference does off
the TPU (its rnn_layer falls back to layers.dropout there).
`lstm_scan` and `reverse_sequence` are the plain formulation of the same
thing, kept as the independent oracle the tests hold the layer to.
"""
from __future__ import annotations

import torch

from e2e_asr_tpu_torch.core import cells
from e2e_asr_tpu_torch.core.layers import dropout
from e2e_asr_tpu_torch.kernels import lstm_bidir


def reverse_sequence(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Reverse x [T, B, ...] along time within each example's length;
    frames at t >= lens[b] keep their position (tf.reverse_sequence)."""
    T = x.shape[0]
    t = torch.arange(T, device=x.device)[:, None]
    lens = lens.to(x.device).long()[None, :]
    idx = torch.where(t < lens, lens - 1 - t, t)            # [T, B]
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand_as(x)
    return torch.gather(x, 0, idx)


def length_mask(lens: torch.Tensor, T: int) -> torch.Tensor:
    """[T, B] float mask, 1.0 where t < lens[b]."""
    t = torch.arange(T, device=lens.device)[:, None]
    return (t < lens.long()[None, :]).float()


def lstm_scan(params: dict, x_seq: torch.Tensor, lens: torch.Tensor
              ) -> torch.Tensor:
    """Unidirectional LSTM over x_seq [T, B, F] -> [T, B, H], zeroed past
    lens. Plain PyTorch (one step per time step)."""
    T, B, in_dim = x_seq.shape
    hidden = params["bias"].shape[0] // 4
    x_proj = cells.lstm_precompute_inputs(params, x_seq, in_dim)
    w_h = params["kernel"][in_dim:]
    state = cells.lstm_zero_state((B,), hidden, device=x_seq.device)
    outputs = []
    for t in range(T):
        out, state = cells._lstm_apply_gates(x_proj[t] + state.h @ w_h,
                                             state.c, hidden)
        outputs.append(out)
    return torch.stack(outputs) * length_mask(lens, T)[:, :, None]


def rnn_layer(params: dict, x_seq: torch.Tensor, lens: torch.Tensor, *,
              cell: str = "lstm", bidirectional: bool = True,
              compute_dtype=None, out_dropout=None) -> torch.Tensor:
    """One bidirectional LSTM layer.

    params: {"fw": cell_params, "bw": cell_params}; x_seq [T, B, F]
    time-major float32; lens [B]. Returns [T, B, 2H] (fw ; bw).
    out_dropout: (keep_prob, mask) for training, mask a bool [T, B, 2H]
    keep-mask (tensors that need a gradient take the training form of the
    kernel and its backward).
    """
    if cell != "lstm":
        raise NotImplementedError("GRU layers are not ported yet "
                                  "(ROADMAP.md Queue 1, 'GRU option')")
    if not bidirectional:
        raise NotImplementedError(
            "forward-only layers need the unidirectional LSTM kernel "
            "(ROADMAP.md Queue 2, kernel #3)")
    if compute_dtype is not None:
        raise NotImplementedError("bf16 compute is not ported yet "
                                  "(ROADMAP.md Queue 1, 'Decode features')")
    T, B, in_dim = x_seq.shape
    lens = lens.to(x_seq.device)
    x_proj_fw = cells.lstm_precompute_inputs(params["fw"], x_seq, in_dim)
    x_proj_bw = cells.lstm_precompute_inputs(params["bw"],
                                             torch.flip(x_seq, [0]), in_dim)
    t = torch.arange(T, device=x_seq.device)[:, None]
    valid = (t >= T - lens.long()[None, :]).float()[:, :, None]   # [T,B,1]
    h_fw, h_bw_flip = lstm_bidir.lstm_seq_bidir(
        x_proj_fw.contiguous(), x_proj_bw.contiguous(),
        params["fw"]["kernel"][in_dim:], params["bw"]["kernel"][in_dim:],
        valid)
    fw_out = h_fw * length_mask(lens, T)[:, :, None]
    bw_out = torch.flip(h_bw_flip * valid, [0])
    out = torch.cat([fw_out, bw_out], dim=-1)
    if out_dropout is not None:
        keep, mask = out_dropout
        out = dropout(out, keep, mask=mask)
    return out
