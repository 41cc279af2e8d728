"""Kernel #18: the transformer encoder's self-attention core
(`csrc/mhsa.cu`).

Replaces: e2e_asr_tpu/ops/mhsa_pallas.py `_fwd` (body `_fwd_kernel`), behind
its custom-VJP entry `attend`. For q, k, v [B, nh, T, hd]:

    scores = (Q_h K_h^T) * 1/sqrt(hd) + relmat[h] + pad_bias[b]
    probs  = softmax(scores) over the keys (row max subtracted first)
    out_h  = probs V_h

Returns out [B, nh, T, hd] and, where asked for, probs [B, nh, T, T] in
float32. A query row whose keys all carry -1e30 (a zero-length slot) comes
out uniform, as jax.nn.softmax gives it; the encoder masks such rows.

The encoder takes it where the JAX package does (models/transformer_encoder
`_mhsa`): in inference, with a padding-only bias, when E2E_ASR_MHSA_KERNEL is
set (read at each call, as `mhsa_pallas.enabled`). The TPU admission logic
(`_vmem_bytes`, `supported`) is not ported: the kernel checks its own limits
(hd a multiple of 4, at most 256) and raises ValueError beyond them, before
the launch; it never falls back.

Backward: `_Attend` keeps the probs and runs `_attend_bwd`'s direct chain
from them in plain PyTorch matmuls (dV = P^T g, dP = g V^T, the softmax VJP,
dQ and dK scaled by 1/sqrt(hd), drel summed over the batch, a zero
pad-bias cotangent); the JAX package has no Pallas backward either.

Bound on the H100: latency at the encoder's shapes (T' <= 64 after the 8x
subsample: at B=8, nh=4, hd=128 it moves about 4.8 MB). Design: one block
per (query tile of 32 rows, head, batch item); K then V staged through
shared memory in chunks of 32 keys (details in the CUDA source).
"""
from __future__ import annotations

import math
import os

import torch

from e2e_asr_tpu_torch.kernels import build

NEG_INF = -1e30
MAX_HD = 256          # head widths the kernel takes: multiples of 4 up to this
LAUNCHES = 0


def enabled() -> bool:
    """The JAX package's opt-in (E2E_ASR_MHSA_KERNEL), read at each call."""
    return bool(os.environ.get("E2E_ASR_MHSA_KERNEL"))


def attend_reference(q, k, v, pad_bias, relmat=None):
    """The plain matmul chain (mhsa_pallas._replay, the encoder's XLA path):
    -> (out [B, nh, T, hd], probs [B, nh, T, T]). relmat None adds
    nothing."""
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if relmat is not None:
        s = s + relmat[None]
    probs = torch.softmax(s + pad_bias[:, None, None, :], dim=-1)
    return torch.matmul(probs, v), probs


def attend_bwd(q, k, v, probs, g):
    """Gradients of out = softmax(...) V from the saved probs:
    (dq, dk, dv, drel [nh, T, T])."""
    scale = math.sqrt(q.shape[-1])
    dv = torch.matmul(probs.transpose(-1, -2), g)
    dprobs = torch.matmul(g, v.transpose(-1, -2))
    ds = probs * (dprobs - (dprobs * probs).sum(-1, keepdim=True))
    dq = torch.matmul(ds, k) / scale
    dk = torch.matmul(ds.transpose(-1, -2), q) / scale
    return dq, dk, dv, ds.sum(0)


def _check(q, k, v, pad_bias, relmat) -> tuple:
    dev = q.device
    if q.dim() != 4:
        raise ValueError(f"mhsa: q must be [B, nh, T, hd], got "
                         f"{tuple(q.shape)}")
    B, nh, T, hd = q.shape
    if hd % 4 or hd > MAX_HD:
        raise ValueError(f"mhsa: head width {hd} is not a multiple of 4 up "
                         f"to {MAX_HD}, the kernel's limit")
    if B > 65535 or nh > 65535 or T < 1:
        raise ValueError(f"mhsa: B={B}, nh={nh}, T={T} outside the grid")
    f32, req = torch.float32, build.require
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        req(t, name, f32, (B, nh, T, hd), dev)
        if t.data_ptr() % 16:
            raise ValueError(f"mhsa: {name} is not 16-byte aligned")
    req(pad_bias, "pad_bias", f32, (B, T), dev)
    req(relmat, "relmat", f32, (nh, T, T), dev)
    return B, nh, T, hd


def _forward(q, k, v, pad_bias, relmat):
    """(out, probs) by the kernel on the card, the plain version on the
    CPU."""
    global LAUNCHES
    if q.device.type == "cpu":
        return attend_reference(q, k, v, pad_bias, relmat)
    if q.device.type != "cuda":
        raise ValueError(f"mhsa: unsupported device {q.device}")
    B, nh, T, hd = _check(q, k, v, pad_bias, relmat)
    dev = q.device
    out = torch.empty(B, nh, T, hd, device=dev)
    probs = torch.empty(B, nh, T, T, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.e2e_mhsa_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               pad_bias.data_ptr(), relmat.data_ptr(),
                               out.data_ptr(), probs.data_ptr(), B, nh, T,
                               hd, build.stream_ptr(dev))
    build.check(err, "mhsa")
    LAUNCHES += 1
    return out, probs


class _Attend(torch.autograd.Function):
    """The forward (kernel or plain version) with the direct backward from
    the saved probs."""

    @staticmethod
    def forward(ctx, q, k, v, pad_bias, relmat):
        out, probs = _forward(q, k, v, pad_bias, relmat)
        ctx.save_for_backward(q, k, v, probs)
        ctx.mark_non_differentiable(probs)
        return out, probs

    @staticmethod
    def backward(ctx, g, _):
        q, k, v, probs = ctx.saved_tensors
        dq, dk, dv, drel = attend_bwd(q, k, v, probs, g)
        dpad = (torch.zeros(q.shape[0], q.shape[2], device=q.device)
                if ctx.needs_input_grad[3] else None)
        return dq, dk, dv, dpad, drel


def attend(q, k, v, pad_bias, relmat, *, bf16: bool = False,
           return_probs: bool = False):
    """Fused attention core: softmax(QK^T/sqrt(hd) + relmat + pad_bias) V.

    q, k, v: [B, nh, T, hd] float32, contiguous; pad_bias: [B, T] additive
    (0 valid, -1e30 padding); relmat: [nh, T, T] additive (zeros when
    unused). Returns out [B, nh, T, hd], or (out, probs [B, nh, T, T]) with
    return_probs. Differentiable in q, k, v and relmat."""
    if bf16:
        raise NotImplementedError("bf16 attention matmuls are not ported yet "
                                  "(ROADMAP.md Queue 1, 'Decode features')")
    args = (q, k, v, pad_bias, relmat)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        out, probs = _Attend.apply(*args)
    else:
        out, probs = _forward(*args)
    return (out, probs) if return_probs else out
