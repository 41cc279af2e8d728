"""Sequence losses (port of e2e_asr_tpu/core/losses.py).

Masked sparse-softmax cross entropy, normalized as the reference: the
per-example sum over time divided by that example's target length, then the
mean over the batch.
"""
from __future__ import annotations

import torch


def _time_mask(seq_len: torch.Tensor, T: int, dtype) -> torch.Tensor:
    t = torch.arange(T, device=seq_len.device)[:, None]
    return (t < seq_len.long()[None, :]).to(dtype)


def shifted_targets(dec_inputs: torch.Tensor, seq_len: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Targets are the decoder inputs shifted by one step.

    dec_inputs: [T, B] time-major ids starting with <go>. Returns
    (targets [T-1, B], mask [T-1, B]) with mask[t, b] = t < seq_len[b]."""
    targets = dec_inputs[1:]
    return targets, _time_mask(seq_len, targets.shape[0], torch.float32)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       seq_len: torch.Tensor, label_smoothing: float = 0.0,
                       weights: torch.Tensor | None = None) -> torch.Tensor:
    """Length-normalized masked CE. logits [T, B, V] time-major, targets
    [T, B], seq_len [B]. label_smoothing e makes the target distribution
    (1-e)*onehot + e/V uniform. weights: optional [B] row validity (the
    padded rows of a tail batch get 0); the batch mean then runs over the
    valid rows only."""
    log_probs = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(log_probs, -1, targets.long()[..., None])[..., 0]
    if label_smoothing > 0.0:
        uniform_nll = -torch.mean(log_probs, dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * uniform_nll
    mask = _time_mask(seq_len, targets.shape[0], logits.dtype)
    per_example = torch.sum(nll * mask, dim=0) / torch.clamp(
        seq_len.to(logits.dtype), min=1.0)
    if weights is not None:
        w = weights.to(per_example.dtype)
        return torch.sum(per_example * w) / torch.clamp(torch.sum(w), min=1.0)
    return torch.mean(per_example)
