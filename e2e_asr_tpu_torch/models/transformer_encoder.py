"""Self-attention (transformer) encoder family (port of
e2e_asr_tpu/models/transformer_encoder.py), selected with
`EncoderConfig.encoder_type = "transformer"`.

One stack-and-project subsampling stage (encoder.pyramid_reduce, default 8x)
and then pre-LN blocks: sinusoidal positions, multi-head self-attention
over the valid frames (with a learned relative-position bias when
`rel_pos_bias`), an optional Conformer-style convolution module
(`conv_kernel`), a GELU FFN, and residual dropout at keep `out_prob` in
training. Same contract as the RNN encoder: per-depth (attention_states,
time_major_states, seq_lens), depth d the output of block d, with
d_model = hidden_size * (2 if bi_dir else 1).

The attention core takes kernel #18 (kernels/mhsa.py) where the JAX
package takes its Pallas kernel: in inference, when E2E_ASR_MHSA_KERNEL is
set. Training and every other case run the plain matmul chain, which
autograd differentiates.

Not ported yet: the MoE FFN (`moe_experts`), chunk-causal attention
(`attn_chunk`, its banded form and `apply_streaming`), and per-block
rematerialization (`remat`); each raises NotImplementedError.
"""
from __future__ import annotations

import numpy as np
import torch

from e2e_asr_tpu_torch.config import EncoderConfig
from e2e_asr_tpu_torch.core.layers import (dense, dense_params, dropout,
                                           dropout_mask, gelu,
                                           glorot_uniform, layer_norm)
from e2e_asr_tpu_torch.kernels import mhsa

REL_RADIUS = 64   # relative distances are clamped to [-63, 63]


def d_model(cfg: EncoderConfig) -> int:
    return cfg.hidden_size * (2 if cfg.bi_dir else 1)


def check_supported(cfg: EncoderConfig) -> None:
    if cfg.moe_experts > 0:
        raise NotImplementedError("the transformer encoder's MoE FFN is not "
                                  "ported yet (ROADMAP.md Queue 1, "
                                  "'Transformer family')")
    if cfg.attn_chunk > 0:
        raise NotImplementedError("chunk-causal attention (-attn_chunk) and "
                                  "transformer streaming are not ported yet "
                                  "(ROADMAP.md Queue 1, 'Transformer "
                                  "family')")


def _norm_params(D: int, device) -> dict:
    return {"scale": torch.ones(D, device=device),
            "bias": torch.zeros(D, device=device)}


def init(gen: torch.Generator, cfg: EncoderConfig, max_depth: int,
         feat_dim: int, *, device=None) -> dict:
    """Parameters named as the JAX package's init: input_proj,
    block_i/{ln1, qkv, attn_out, ln2, ffn1, ffn2, rel_bias, conv/{ln, pw1,
    dw, ln2, pw2}}, ln_out."""
    check_supported(cfg)
    D = d_model(cfg)
    F_in = feat_dim * cfg.stack_cons * cfg.subsample
    params: dict = {"input_proj": dense_params(gen, F_in, D, device=device)}
    for i in range(1, max_depth + 1):
        blk = {"ln1": _norm_params(D, device),
               "qkv": dense_params(gen, D, 3 * D, device=device),
               "attn_out": dense_params(gen, D, D, device=device),
               "ln2": _norm_params(D, device),
               "ffn1": dense_params(gen, D, cfg.ffn_mult * D, device=device),
               "ffn2": dense_params(gen, cfg.ffn_mult * D, D, device=device)}
        if cfg.rel_pos_bias:
            # Zero-init: at init the model is the sinusoidal-only baseline.
            blk["rel_bias"] = torch.zeros(cfg.num_heads, 2 * REL_RADIUS - 1,
                                          device=device)
        if cfg.conv_kernel > 0:
            blk["conv"] = {
                "ln": _norm_params(D, device),
                "pw1": dense_params(gen, D, 2 * D, device=device),
                "dw": glorot_uniform(gen, (cfg.conv_kernel, D),
                                     device=device),
                "ln2": _norm_params(D, device),
                "pw2": dense_params(gen, D, D, device=device)}
        params[f"block_{i}"] = blk
    params["ln_out"] = _norm_params(D, device)
    return params


def _sinusoidal_at(positions: torch.Tensor, D: int) -> torch.Tensor:
    """Sinusoidal encoding at integer positions [...] -> [..., D] float32:
    sin on the even features, cos on the odd ones (interleaved), the angle
    pos / 10000^(2i/D) in float32."""
    pos = positions.to(torch.float32)[..., None]
    dim = torch.arange(D // 2, dtype=torch.float32,
                       device=positions.device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=positions.device),
                            2.0 * dim / D)
    pe = torch.zeros(angle.shape[:-1] + (D,), device=positions.device)
    pe[..., 0::2] = torch.sin(angle)
    pe[..., 1::2] = torch.cos(angle)
    return pe


def _rel_bias(table: torch.Tensor, T: int) -> torch.Tensor:
    """[nh, 2R-1] bias table -> [nh, T, T] additive attention bias, the
    relative distance q - k clamped to the table's radius."""
    dist = np.arange(T)[:, None] - np.arange(T)[None, :]
    idx = np.clip(dist, -(REL_RADIUS - 1), REL_RADIUS - 1) + REL_RADIUS - 1
    return table[:, torch.as_tensor(idx, device=table.device)]


def _conv_module(p: dict, h: torch.Tensor, vmask: torch.Tensor
                 ) -> torch.Tensor:
    """LN -> pointwise(2D) -> GLU (masked) -> depthwise conv (XLA's SAME
    padding) -> LN -> swish -> pointwise(D)."""
    D = h.shape[-1]
    kk = p["dw"].shape[0]
    x = dense(p["pw1"], layer_norm(p["ln"], h))
    a, b = x.split(D, dim=-1)
    x = (a * torch.sigmoid(b)) * vmask
    lo = (kk - 1) // 2
    x = torch.nn.functional.pad(x.transpose(1, 2), (lo, kk - 1 - lo))
    x = torch.nn.functional.conv1d(x, p["dw"].t()[:, None, :], groups=D)
    x = layer_norm(p["ln2"], x.transpose(1, 2))
    return dense(p["pw2"], x * torch.sigmoid(x))


def _mhsa(p: dict, h: torch.Tensor, pad_bias: torch.Tensor, num_heads: int,
          train: bool = False) -> torch.Tensor:
    """Self-attention over h [B, T, D] with the padding bias [B, T]."""
    B, T, D = h.shape
    hd = D // num_heads
    q, k, v = (t.reshape(B, T, num_heads, hd).transpose(1, 2)
               for t in dense(p["qkv"], h).split(D, dim=-1))
    if not train and mhsa.enabled():
        relmat = (_rel_bias(p["rel_bias"], T) if "rel_bias" in p
                  else torch.zeros(num_heads, T, T, device=h.device))
        o = mhsa.attend(q.contiguous(), k.contiguous(), v.contiguous(),
                        pad_bias, relmat.contiguous())
    else:
        relmat = _rel_bias(p["rel_bias"], T) if "rel_bias" in p else None
        o, _ = mhsa.attend_reference(q, k, v, pad_bias, relmat)
    return dense(p["attn_out"], o.transpose(1, 2).reshape(B, T, D))


def _ffn_fwd(blk: dict, h: torch.Tensor) -> torch.Tensor:
    return dense(blk["ffn2"], gelu(dense(blk["ffn1"],
                                         layer_norm(blk["ln2"], h))))


def block_fwd(blk: dict, h: torch.Tensor, pad_bias: torch.Tensor,
              vmask: torch.Tensor, masks, keep: float, cfg: EncoderConfig,
              train: bool = False) -> torch.Tensor:
    """One pre-LN block; masks: the (attention, conv, FFN) keep-masks
    [B, T, D] of training dropout (conv None without a conv module)."""
    a = _mhsa(blk, layer_norm(blk["ln1"], h), pad_bias, cfg.num_heads,
              train=train)
    if train and keep < 1.0:
        a = dropout(a, keep, mask=masks[0])
    h = h + a
    if "conv" in blk:
        c = _conv_module(blk["conv"], h, vmask)
        if train and keep < 1.0:
            c = dropout(c, keep, mask=masks[1])
        h = h + c
    f = _ffn_fwd(blk, h)
    if train and keep < 1.0:
        f = dropout(f, keep, mask=masks[2])
    return h + f


def apply(params: dict, cfg: EncoderConfig, x: torch.Tensor,
          seq_len: torch.Tensor, num_layers: dict[str, int], *,
          train: bool = False, gen=None, drop_masks: dict | None = None):
    """Same contract as encoder.apply: x [B, T, F] (frame-stacked), seq_len
    [B]. train: residual dropout, block i's keep-masks from drop_masks
    {i: (attention, conv, FFN) bool [B, T', D]} where given, else drawn
    from `gen` (the JAX package draws them from fold_in(rng, 3i), 3i+1 and
    3i+2). Returns per-depth (attention_states [B, T', D], time_major_states
    [T', B, D], seq_lens [B])."""
    from e2e_asr_tpu_torch.models.encoder import pyramid_reduce

    check_supported(cfg)
    if train and cfg.remat:
        raise NotImplementedError("remat is not ported yet (ROADMAP.md "
                                  "Queue 1, 'Training extensions')")
    max_depth = max(num_layers.values())
    want_attn = {d for t, d in num_layers.items() if t != "state"}
    want_tm = {d for t, d in num_layers.items() if t == "state"}
    seq_len = seq_len.to(x.device).long()
    if cfg.subsample > 1:
        x, lens = pyramid_reduce(x, seq_len, cfg.subsample)
    else:
        lens = seq_len
    B, T, _ = x.shape
    D = d_model(cfg)
    h = dense(params["input_proj"], x)
    h = h + _sinusoidal_at(torch.arange(T, device=x.device), D)
    valid = torch.arange(T, device=x.device)[None, :] < lens[:, None]
    pad_bias = torch.where(valid, 0.0, mhsa.NEG_INF)
    vmask = valid.to(h.dtype)[:, :, None]
    keep = cfg.out_prob if train else 1.0

    attn_states, time_major, seq_lens = {}, {}, {}
    for i in range(1, max_depth + 1):
        blk = params[f"block_{i}"]
        masks = (drop_masks or {}).get(i)
        if train and keep < 1.0:
            if masks is None:
                masks = tuple(
                    dropout_mask(gen, (B, T, D), keep, x.device)
                    if j != 1 or "conv" in blk else None for j in range(3))
            masks = tuple(None if m is None else m.to(x.device)
                          for m in masks)
        h = block_fwd(blk, h, pad_bias, vmask, masks, keep, cfg, train=train)
        if i in want_attn or i in want_tm:
            out = layer_norm(params["ln_out"], h) * vmask
            if i in want_attn:
                attn_states[i] = out
            if i in want_tm:
                time_major[i] = out.transpose(0, 1)
            seq_lens[i] = lens
    return attn_states, time_major, seq_lens
