"""Seq2seq assembly: encoder + one attention decoder per task (port of the
inference half of e2e_asr_tpu/models/seq2seq.py)."""
from __future__ import annotations

import torch

from e2e_asr_tpu_torch.shared import Seq2SeqConfig
from e2e_asr_tpu_torch.models import attn_decoder, encoder


def check_supported(cfg: Seq2SeqConfig) -> None:
    if cfg.model_family != "attention":
        raise NotImplementedError(
            f"the {cfg.model_family} family is not ported yet (ROADMAP.md "
            "Queue 1, 'CTC family' / 'Transducer')")


def init(gen: torch.Generator, cfg: Seq2SeqConfig, *, device=None) -> dict:
    """Random parameters laid out like e2e_asr_tpu.models.seq2seq.init."""
    check_supported(cfg)
    max_depth = max(cfg.num_layers.values())
    attn_size = cfg.encoder.hidden_size * (2 if cfg.encoder.bi_dir else 1)
    params = {"encoder": encoder.init(gen, cfg.encoder, max_depth,
                                      cfg.feat_length, device=device)}
    for task in cfg.tasks:
        params[f"decoder_{task}"] = attn_decoder.init(
            gen, cfg.decoders[task], attn_size, device=device)
    return params


def stack_frames(x: torch.Tensor, stack_cons: int) -> torch.Tensor:
    """Concat stack_cons consecutive frames on the feature axis with forward
    shifts, zero-padded at the tail."""
    if stack_cons <= 1:
        return x
    parts = [x]
    for shift in range(1, stack_cons):
        parts.append(torch.nn.functional.pad(x[:, shift:, :],
                                             (0, 0, 0, shift)))
    return torch.cat(parts, dim=2)


def encode(params: dict, cfg: Seq2SeqConfig, feats: torch.Tensor,
           feat_lens: torch.Tensor, *, train: bool = False,
           compute_dtype=None):
    """feats [B, T, feat] -> encoder.apply's (attention_states,
    time_major_states, seq_lens)."""
    feats = stack_frames(feats, cfg.encoder.stack_cons)
    return encoder.apply(params["encoder"], cfg.encoder, feats, feat_lens,
                         cfg.num_layers, train=train,
                         compute_dtype=compute_dtype)


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_count(v) for v in params)
    return params.numel()
