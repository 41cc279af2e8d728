"""Kernel #13: the additive attention folded into kernel C, for all k beams
of a decoder step (`csrc/attn_output.cu`).

Replaces: e2e_asr_tpu/ops/dec_step_pallas.py `attn_output_fused`. For every
row: scores s = v . tanh(hf + y), -1e30 where the frame is padding; softmax
to alpha; context = alpha @ enc; AttnProjection([query, context]) ->
OutputProjection -> log_softmax over the true V (no 128-lane padding: that
was a TPU layout). Returns (logp [N, V], context [N, H_enc], alpha [N, T]).

Row order: b-major, row n = b*k + j for beam j of utterance b, as the
per-step search lays out its rows (kernels/beam_mega.py `search`). The
Pallas kernel takes k-major rows (j*B + b); each (b, j) gets the same
values.

The decode step takes it where `attn_output_fits` admits it: opt-in through
E2E_ASR_FUSED_ATTN, read at each call as the JAX package reads it. The JAX
gate's VMEM estimate has no counterpart: the kernel checks its own limits
(A + T <= 8192) and raises beyond them; it never falls back.

Bound on the H100: latency, as kernels B and C. Design: one cooperative
launch, a block per row for the scores, the masked softmax and the context,
then C's tiled projections and its log_softmax, a grid barrier between the
stages (details in the source).
"""
from __future__ import annotations

import os

import torch

from e2e_asr_tpu_torch.kernels import build, dec_step

NEG_INF = -1e30
MAX_SCORES = 8192     # A + T: the floats of a block's score buffer
LAUNCHES = 0


def attn_output_fits(B: int, k: int, T_enc: int, A: int, H_enc: int) -> bool:
    """Whether a decode step over B utterances x k beams takes kernel #13:
    when E2E_ASR_FUSED_ATTN is set (the JAX package's opt-in, read at each
    call). The shapes are the JAX gate's arguments; beyond the kernel's
    limits it raises instead of falling back."""
    return bool(os.environ.get("E2E_ASR_FUSED_ATTN"))


def attend(params: dict, y, hf, enc, mask, *, k: int):
    """The plain additive attention over b-major rows: y [B*k, A], hf
    [B, T, A], enc [B, T, H_enc], mask [B, T] 1/0 -> (context
    [B*k, H_enc], alpha [B*k, T])."""
    B, T, _ = hf.shape
    s = (params["attn_v"] * torch.tanh(
        hf[:, None] + y.view(B, k, 1, -1))).sum(-1)
    s = torch.where(mask[:, None] > 0, s, NEG_INF)
    alpha = torch.softmax(s, dim=-1)                        # [B, k, T]
    return torch.bmm(alpha, enc).view(B * k, -1), alpha.view(B * k, T)


def attn_output_fused_reference(params: dict, cfg, y, query, hf, enc, mask,
                                *, k: int):
    """Plain PyTorch version of the kernel: the same arguments and
    results."""
    context, alpha = attend(params, y, hf, enc, mask, k=k)
    return (dec_step.output_fused_reference(params, cfg, query, context),
            context, alpha)


def attn_output_fused(params: dict, cfg, y, query, hf, enc, mask, *, k: int,
                      bf16: bool = False):
    """Attention + AttnProjection + OutputProjection + log_softmax of one
    decoder step. y [N, A] (the query projection), query [N, H] (the top
    cell's c for LSTM cells, h for GRU cells), b-major rows N = B*k; hf
    [B, T, A], enc [B, T, H_enc], mask [B, T]. Returns (logp [N, V],
    context [N, H_enc], alpha [N, T])."""
    global LAUNCHES
    dec_step.check_bf16(bf16)
    if y.device.type == "cpu":
        return attn_output_fused_reference(params, cfg, y, query, hf, enc,
                                           mask, k=k)
    if y.device.type != "cuda":
        raise ValueError(f"attn_output_fused: unsupported device {y.device}")
    dev = y.device
    N, A = y.shape
    H = query.shape[-1]
    B, T, Henc = enc.shape
    out = dec_step.out_proj(params, cfg)
    V = out["kernel"].shape[-1]
    if N != B * k:
        raise ValueError(f"attn_output_fused: {N} rows for {B} utterances x "
                         f"{k} beams")
    if A + T > MAX_SCORES:
        raise ValueError(f"attn_output_fused: attention size {A} + {T} "
                         f"frames exceeds the kernel's {MAX_SCORES}")
    f32 = torch.float32
    req = build.require
    req(y, "y", f32, (N, A), dev)
    req(query, "query", f32, (N, H), dev)
    req(hf, "hf", f32, (B, T, A), dev)
    req(enc, "enc", f32, (B, T, Henc), dev)
    req(mask, "mask", f32, (B, T), dev)
    req(params["attn_v"], "attn_v", f32, (A,), dev)
    ap = params["attn_proj"]
    req(ap["kernel"], "attn_proj/kernel", f32, (H + Henc, H), dev)
    req(ap["bias"], "attn_proj/bias", f32, (H,), dev)
    req(out["kernel"], "output_proj/kernel", f32, (H, V), dev)
    req(out["bias"], "output_proj/bias", f32, (V,), dev)
    widths = [V, Henc, T, H]
    flat = torch.empty(N * sum(widths), device=dev)
    logp, context, alpha, proj = [   # proj: scratch
        part.view(N, w) for part, w in zip(
            flat.split([N * w for w in widths]), widths)]
    lib = build.library()
    ptr_list = [y, query, hf, enc, mask, params["attn_v"], ap["kernel"],
                ap["bias"], out["kernel"], out["bias"], logp, context, alpha,
                proj]
    with torch.cuda.device(dev):
        err = lib.e2e_attn_output_fused(
            build.ptrs(*ptr_list), len(ptr_list),
            build.ints(N, k, T, A, H, Henc, V), 7, build.stream_ptr(dev))
    build.check(err, "attn_output_fused")
    LAUNCHES += 1
    return logp, context, alpha
