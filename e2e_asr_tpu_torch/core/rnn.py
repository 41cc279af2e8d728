"""Length-aware RNN layers over time (port of e2e_asr_tpu/core/rnn.py).

Semantics of tf.nn.(bidirectional_)dynamic_rnn, as in the reference:
- outputs at t >= seq_len are zeroed,
- the backward direction of a bidirectional layer sees each example
  reversed within its own length.

`lstm_scan` runs one direction through kernel #3 (kernels/lstm_seq.py),
`gru_scan` through kernel #6 (kernels/gru_seq.py). The bidirectional layer
flips the whole sequence (padding then leads) and runs both directions in
one launch of kernel A (kernels/lstm_bidir.py) or, for GRU cells, of
kernel #6, whose backward direction carries its state through the leading
padding; that equals reversing within each length.
Gradients flow through the kernels' backward. Training dropout is applied
to the layer's output outside the kernels, as the reference does off the
TPU (its rnn_layer falls back to layers.dropout there).
`lstm_scan_reference` and `reverse_sequence` are the plain formulation of
the same thing, kept as the independent oracle the tests hold the layers
to.
"""
from __future__ import annotations

import torch

from e2e_asr_tpu_torch.core import cells
from e2e_asr_tpu_torch.core.layers import dropout
from e2e_asr_tpu_torch.kernels import gru_seq, lstm_bidir, lstm_seq


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


def lstm_scan_reference(params: dict, x_seq: torch.Tensor,
                        lens: torch.Tensor) -> torch.Tensor:
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


def lstm_scan(params: dict, x_seq: torch.Tensor, lens: torch.Tensor
              ) -> torch.Tensor:
    """Unidirectional LSTM over x_seq [T, B, F] -> [T, B, H], zeroed past
    lens: the input projection in one matmul, the recurrence in kernel #3
    (its plain version for CPU tensors)."""
    T, _, in_dim = x_seq.shape
    x_proj = cells.lstm_precompute_inputs(params, x_seq, in_dim)
    out = lstm_seq.lstm_seq(x_proj.contiguous(), params["kernel"][in_dim:])
    return out * length_mask(lens.to(x_seq.device), T)[:, :, None]


def gru_scan(params: dict, x_seq: torch.Tensor, lens: torch.Tensor
             ) -> torch.Tensor:
    """Unidirectional GRU over x_seq [T, B, F] -> [T, B, H], zeroed past
    lens: the input contributions in one matmul each, the recurrence in
    kernel #6 (its plain version for CPU tensors)."""
    T, _, in_dim = x_seq.shape
    gates_x, cand_x = cells.gru_precompute_inputs(params, x_seq, in_dim)
    out = gru_seq.gru_seq(gates_x.contiguous(), cand_x.contiguous(),
                          params["gates"]["kernel"][in_dim:],
                          params["candidate"]["kernel"][in_dim:])
    return out * length_mask(lens.to(x_seq.device), T)[:, :, None]


def _bidir(params: dict, x_seq: torch.Tensor, valid: torch.Tensor,
           cell: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Both directions in one kernel launch: (h_fw, h_bw of the flipped
    sequence), unmasked."""
    in_dim = x_seq.shape[-1]
    fw, bw = params["fw"], params["bw"]
    x_flip = torch.flip(x_seq, [0])
    if cell == "lstm":
        return lstm_bidir.lstm_seq_bidir(
            cells.lstm_precompute_inputs(fw, x_seq, in_dim).contiguous(),
            cells.lstm_precompute_inputs(bw, x_flip, in_dim).contiguous(),
            fw["kernel"][in_dim:], bw["kernel"][in_dim:], valid)
    gx_fw, cx_fw = cells.gru_precompute_inputs(fw, x_seq, in_dim)
    gx_bw, cx_bw = cells.gru_precompute_inputs(bw, x_flip, in_dim)
    return gru_seq.gru_seq_bidir(
        gx_fw.contiguous(), cx_fw.contiguous(), gx_bw.contiguous(),
        cx_bw.contiguous(), fw["gates"]["kernel"][in_dim:],
        fw["candidate"]["kernel"][in_dim:], bw["gates"]["kernel"][in_dim:],
        bw["candidate"]["kernel"][in_dim:], valid)


def rnn_layer(params: dict, x_seq: torch.Tensor, lens: torch.Tensor, *,
              cell: str = "lstm", bidirectional: bool = True,
              compute_dtype=None, out_dropout=None) -> torch.Tensor:
    """One LSTM or GRU layer, bidirectional or forward-only.

    params: {"fw": cell_params, "bw": cell_params} ({"fw": ...} alone when
    forward-only); x_seq [T, B, F] time-major float32; lens [B]. Returns
    [T, B, 2H] (fw ; bw), or [T, B, H] forward-only.
    out_dropout: (keep_prob, mask) for training, mask a bool keep-mask of
    the output's shape (tensors that need a gradient take the training form
    of the kernel and its backward).
    """
    if cell not in ("lstm", "gru"):
        raise ValueError(f"unknown cell {cell!r}")
    if compute_dtype is not None:
        raise NotImplementedError("bf16 compute is not ported yet "
                                  "(ROADMAP.md Queue 1, 'Decode features')")
    if not bidirectional:
        scan = lstm_scan if cell == "lstm" else gru_scan
        out = scan(params["fw"], x_seq, lens)
    else:
        T = x_seq.shape[0]
        lens = lens.to(x_seq.device)
        t = torch.arange(T, device=x_seq.device)[:, None]
        valid = (t >= T - lens.long()[None, :]).float()[:, :, None]
        h_fw, h_bw_flip = _bidir(params, x_seq, valid, cell)
        fw_out = h_fw * length_mask(lens, T)[:, :, None]
        bw_out = torch.flip(h_bw_flip * valid, [0])
        out = torch.cat([fw_out, bw_out], dim=-1)
    if out_dropout is not None:
        keep, mask = out_dropout
        out = dropout(out, keep, mask=mask)
    return out
