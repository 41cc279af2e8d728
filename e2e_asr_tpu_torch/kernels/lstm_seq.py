"""Kernel #3: the forward of a unidirectional LSTM over a sequence
(`csrc/lstm_seq.cu`), with its backward on kernel #5
(`lstm_bidir.lstm_bwd`, `csrc/lstm_bidir_bwd.cu`).

Replaces: e2e_asr_tpu/ops/lstm_pallas.py `_fwd_seq` through its entries
`lstm_seq` and `lstm_seq_masked` (without in-kernel dropout), and the
residual-saving training form `_lstm_seq_fwd`, which also writes c.

Bound on the H100: the recurrence, as kernel A's. Each of the T steps
needs the whole previous h, and every step reads all of W_h ([256, 1024]
f32 = 1 MiB at the LM's width) from L2, since it exceeds a block's shared
memory.

Design: kernel A's chain for one direction (`csrc/lstm_fwd.cuh`): one
block per batch row, the time loop inside the block, h in shared memory and
c in registers. At the LM task's B=128 the 128 chains fit one wave on the
132 SMs.

Autograd: `lstm_seq` on inputs that need a gradient runs the training form
inside `_LSTMSeq`, whose backward is kernel #5 on the card and
`lstm_bwd_reference` on the CPU (both through `lstm_bidir.lstm_bwd`).
"""
from __future__ import annotations

import torch

from e2e_asr_tpu_torch.core.cells import _lstm_apply_gates
from e2e_asr_tpu_torch.kernels import build, lstm_bidir

LAUNCHES = 0           # inference form without a mask (lstm_seq)
MASKED_LAUNCHES = 0    # inference form with the carry mask (lstm_seq_masked)
TRAIN_LAUNCHES = 0     # training form (also writes c), with or without mask


def lstm_seq_reference(x_proj, w_h, mask=None, save_c: bool = False):
    """Plain PyTorch version: h [T,B,H] from a zero state, unmasked; with
    save_c, (h, c). mask [T,B,1]: steps where it is 0 keep (c, h)."""
    T, B, H4 = x_proj.shape
    H = H4 // 4
    h = c = x_proj.new_zeros(B, H)
    hs, cs = [], []
    for t in range(T):
        new_h, (new_c, _) = _lstm_apply_gates(x_proj[t] + h @ w_h, c, H)
        if mask is not None:
            valid = mask[t]
            new_c = valid * new_c + (1.0 - valid) * c
            new_h = valid * new_h + (1.0 - valid) * h
        h, c = new_h, new_c
        hs.append(h)
        cs.append(c)
    return (torch.stack(hs), torch.stack(cs)) if save_c else torch.stack(hs)


def _launch(x_proj, w_h, mask, save_c: bool) -> torch.Tensor:
    """One launch of the kernel: [1 or 2, T, B, H] = h (and c)."""
    dev = x_proj.device
    if dev.type != "cuda":
        raise ValueError(f"lstm_seq: unsupported device {dev}")
    T, B, H4 = x_proj.shape
    if H4 % 4:
        raise ValueError(f"x_proj last dim {H4} is not 4*H")
    H = H4 // 4
    f32 = torch.float32
    build.require(x_proj, "x_proj", f32, (T, B, H4), dev)
    build.require(w_h, "w_h", f32, (H, H4), dev)
    if mask is not None:
        build.require(mask, "mask", f32, (T, B, 1), dev)
    out = torch.empty(2 if save_c else 1, T, B, H, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.e2e_lstm_seq_fwd(
            x_proj.data_ptr(), w_h.data_ptr(),
            None if mask is None else mask.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr() if save_c else None, T, B, H,
            build.stream_ptr(dev))
    build.check(err, "lstm_seq")
    return out


def lstm_seq_train(x_proj, w_h, mask=None):
    """The training form: (h, c), each [T,B,H]."""
    global TRAIN_LAUNCHES
    if x_proj.device.type == "cpu":
        return lstm_seq_reference(x_proj, w_h, mask, save_c=True)
    out = _launch(x_proj, w_h, mask, save_c=True)
    TRAIN_LAUNCHES += 1
    return out[0], out[1]


class _LSTMSeq(torch.autograd.Function):
    """Training forward (saves h and c) with kernel #5 as its backward."""

    @staticmethod
    def forward(ctx, x_proj, w_h, mask):
        h, c = lstm_seq_train(x_proj, w_h, mask)
        ctx.save_for_backward(x_proj, w_h, mask, h, c)
        return h

    @staticmethod
    def backward(ctx, g):
        x_proj, w_h, mask, h, c = ctx.saved_tensors
        dx, dw = lstm_bidir.lstm_bwd(w_h, h, c, x_proj, g.contiguous(), mask)
        return dx, dw, None


def lstm_seq(x_proj, w_h, mask=None, drop_seed=None,
             bf16_matmul: bool = False, drop_keep: float = 1.0):
    """Unidirectional LSTM over x_proj [T,B,4H] (input projection + bias)
    with recurrent kernel w_h [H,4H] from a zero state -> h [T,B,H],
    unmasked. mask [T,B,1] float or None: steps where it is 0 carry the
    state through (lstm_pallas.lstm_seq_masked). Differentiable in x_proj
    and w_h: when either needs a gradient, the training form runs and kernel
    #5 gives the gradients. The reference's in-kernel dropout (drop_seed,
    drop_keep) and bf16 matmuls raise: dropout runs on the output outside
    the kernel."""
    global LAUNCHES, MASKED_LAUNCHES
    if drop_seed is not None or drop_keep < 1.0 or bf16_matmul:
        raise NotImplementedError(
            "lstm_seq: in-kernel dropout and bf16 matmuls are not ported "
            "yet (ROADMAP.md Queue 2, 'Speed levers': in-kernel Philox "
            "dropout; Queue 1, 'Decode features': bf16)")
    if torch.is_grad_enabled() and (x_proj.requires_grad
                                    or w_h.requires_grad):
        return _LSTMSeq.apply(x_proj, w_h, mask)
    if x_proj.device.type == "cpu":
        return lstm_seq_reference(x_proj, w_h, mask)
    h = _launch(x_proj, w_h, mask, save_c=False)[0]
    if mask is None:
        LAUNCHES += 1
    else:
        MASKED_LAUNCHES += 1
    return h
