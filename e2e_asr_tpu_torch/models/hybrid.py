"""Hybrid CTC/attention training: one encoder pass, both objectives (port
of e2e_asr_tpu/models/hybrid.py).

    total = (1 - ctc_weight) * attention_CE + ctc_weight * CTC

The attention term is the attention family's per-task cross entropy
(seq2seq.decoder_losses on the port's training decoder: #8/#9, or #10 with
GRU decoders), averaged over the tasks under cfg.avg; the CTC term is a CTC
head on the char task's encoder depth (core/ctc_loss.py). The JAX package
applies no label smoothing to the hybrid's cross entropy, and neither does
the port.
"""
from __future__ import annotations

import torch

from e2e_asr_tpu_torch.config import Seq2SeqConfig
from e2e_asr_tpu_torch.core.ctc_loss import ctc_loss_mean
from e2e_asr_tpu_torch.core.device import resolve
from e2e_asr_tpu_torch.core.layers import dense, dense_params
from e2e_asr_tpu_torch.models import ctc, seq2seq


def init(gen: torch.Generator, cfg: Seq2SeqConfig, *, device=None) -> dict:
    """The attention family's parameters plus a CTC head on the char
    task's encoder depth, on `device` (default: the CUDA card)."""
    device = resolve(device)
    params = seq2seq.init(gen, cfg, device=device)
    attn_size = cfg.encoder.hidden_size * (2 if cfg.encoder.bi_dir else 1)
    params["ctc_head"] = dense_params(gen, attn_size,
                                      cfg.decoders["char"].vocab_size,
                                      device=device)
    return params


def loss(params: dict, cfg: Seq2SeqConfig, batch: dict, *,
         ctc_weight: float, gen=None, noise: dict | None = None,
         compute_dtype=None) -> tuple[torch.Tensor, dict]:
    """(total, {"attention": ..., "ctc": ..., task: CE per task}).

    batch: the attention family's batch plus `labels` [B, L] and
    `label_lens` [B] (token ids without <go>/<eos>, 0-padded) for the CTC
    term. noise as seq2seq.apply_train's: the reference splits the step's
    key into the encoder's and the decoders' exactly as apply_train does.
    """
    ctc._check_dtype(compute_dtype)
    noise = noise or {}
    attn_states, _, enc_lens = seq2seq.encode(
        params, cfg, batch["logmel"], batch["logmel_len"], train=True,
        gen=gen, drop_masks=noise.get("encoder"))
    task_losses = seq2seq.decoder_losses(params, cfg, batch, attn_states,
                                         enc_lens, gen=gen, noise=noise)
    attention = sum(task_losses.values())
    if cfg.avg:
        attention = attention / float(len(cfg.tasks))
    depth = cfg.num_layers["char"]
    ctc_total = ctc_loss_mean(dense(params["ctc_head"], attn_states[depth]),
                              enc_lens[depth], batch["labels"],
                              batch["label_lens"], blank_id=ctc.BLANK_ID)
    total = (1.0 - ctc_weight) * attention + ctc_weight * ctc_total
    return total, {"attention": attention, "ctc": ctc_total, **task_losses}
