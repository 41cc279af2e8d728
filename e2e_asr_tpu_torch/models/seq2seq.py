"""Seq2seq assembly: encoder + one attention decoder per task (port of
e2e_asr_tpu/models/seq2seq.py): init, encode, the training forward and the
greedy decode."""
from __future__ import annotations

import torch

from e2e_asr_tpu_torch.config import Seq2SeqConfig
from e2e_asr_tpu_torch.core import losses
from e2e_asr_tpu_torch.core.device import resolve
from e2e_asr_tpu_torch.data.text import GO_ID
from e2e_asr_tpu_torch.models import attn_decoder, encoder


def check_supported(cfg: Seq2SeqConfig) -> None:
    if cfg.model_family != "attention":
        raise NotImplementedError(
            f"the {cfg.model_family} family is not ported yet (ROADMAP.md "
            "Queue 1, 'CTC family' / 'Transducer')")


def init(gen: torch.Generator, cfg: Seq2SeqConfig, *, device=None) -> dict:
    """Random parameters laid out like e2e_asr_tpu.models.seq2seq.init, on
    `device` (default: the CUDA card; raises without one)."""
    check_supported(cfg)
    device = resolve(device)
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
           compute_dtype=None, gen=None, drop_masks=None):
    """feats [B, T, feat] -> encoder.apply's (attention_states,
    time_major_states, seq_lens)."""
    feats = stack_frames(feats, cfg.encoder.stack_cons)
    return encoder.apply(params["encoder"], cfg.encoder, feats, feat_lens,
                         cfg.num_layers, train=train,
                         compute_dtype=compute_dtype, gen=gen,
                         drop_masks=drop_masks)


def _check_train_supported(cfg: Seq2SeqConfig) -> None:
    if cfg.ctc_weight > 0:
        raise NotImplementedError("the hybrid CTC/attention loss is not "
                                  "ported yet (ROADMAP.md Queue 1, 'CTC "
                                  "family')")
    if cfg.lora_rank > 0:
        raise NotImplementedError("LoRA is not ported yet (ROADMAP.md Queue "
                                  "1, 'Training extensions')")


def apply_train(params: dict, cfg: Seq2SeqConfig, batch: dict, *,
                gen: torch.Generator | None = None, noise: dict | None = None
                ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Full training forward: returns (total_loss, per-task losses).

    batch: {"logmel": [B,T,F], "logmel_len": [B], task: [B,T_task] ids
    starting with <go>, f"{task}_len": [B]} as tensors on the parameters'
    device. Target lengths count the shifted targets (incl. <eos>).
    noise: {"encoder": {depth: bool keep-mask [T_d, B, 2H]}, task:
    attn_decoder.train_noise tuple}; whatever it lacks is drawn from `gen`.
    The reference draws the encoder's from fold_in(rng_enc, depth) and task
    i's decoder noise from fold_in(rng_dec, i).
    """
    check_supported(cfg)
    _check_train_supported(cfg)
    noise = noise or {}
    attn_states, _, enc_lens = encode(params, cfg, batch["logmel"],
                                      batch["logmel_len"], train=True,
                                      gen=gen, drop_masks=noise.get("encoder"))
    task_losses = {}
    for task in cfg.tasks:
        depth = cfg.num_layers[task]
        dec_inputs = batch[task].transpose(0, 1)                 # [T, B]
        logits = attn_decoder.apply_train(
            params[f"decoder_{task}"], cfg.decoders[task], dec_inputs,
            attn_states[depth], enc_lens[depth], gen=gen,
            noise=noise.get(task))
        targets, _ = losses.shifted_targets(dec_inputs, batch[f"{task}_len"])
        task_losses[task] = losses.cross_entropy_loss(
            logits, targets, batch[f"{task}_len"],
            label_smoothing=cfg.label_smoothing)
    total = sum(task_losses.values())
    if cfg.avg:
        total = total / float(len(cfg.tasks))
    return total, task_losses


@torch.no_grad()
def apply_greedy(params: dict, cfg: Seq2SeqConfig, feats: torch.Tensor,
                 feat_lens: torch.Tensor, *, task: str = "char",
                 go_id: int = GO_ID) -> torch.Tensor:
    """Greedy decode of a batch with early exit (attn_decoder.
    apply_infer_early): token ids [B, max_output], <pad> past each row's
    <eos>. feats [B, T, feat] on the parameters' device."""
    check_supported(cfg)
    attn_states, _, enc_lens = encode(params, cfg, feats, feat_lens)
    depth = cfg.num_layers[task]
    go_ids = torch.full((feats.shape[0],), go_id, dtype=torch.long,
                        device=feats.device)
    ids = attn_decoder.apply_infer_early(
        params[f"decoder_{task}"], cfg.decoders[task], go_ids,
        attn_states[depth], enc_lens[depth], max_output=cfg.max_output[task])
    return ids.transpose(0, 1)


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_count(v) for v in params)
    return params.numel()
