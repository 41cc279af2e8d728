"""CTC model family: the encoder with a per-frame CTC head (port of
e2e_asr_tpu/models/ctc.py).

The attention family's pyramidal encoder (seq2seq.encode, on its kernels)
feeds a [2H, V] projection trained with the CTC loss (core/ctc_loss.py,
optax's recursion) and decoded by best path: per-frame argmax, repeats
collapsed, blanks dropped.

Conventions: blank id = 0 (the <pad> slot, which never appears in labels);
labels are the raw token sequence without <go>/<eos> framing. bf16 compute
raises.
"""
from __future__ import annotations

import torch

from e2e_asr_tpu_torch.config import Seq2SeqConfig
from e2e_asr_tpu_torch.core.ctc_loss import ctc_loss_mean
from e2e_asr_tpu_torch.core.device import resolve
from e2e_asr_tpu_torch.core.layers import dense, dense_params
from e2e_asr_tpu_torch.models import encoder as encoder_lib
from e2e_asr_tpu_torch.models import seq2seq

BLANK_ID = 0


def _check_dtype(compute_dtype) -> None:
    if compute_dtype is not None:
        raise NotImplementedError("bf16 compute is not ported yet "
                                  "(ROADMAP.md Queue 1, 'Decode features')")


def init(gen: torch.Generator, cfg: Seq2SeqConfig, vocab_size: int, *,
         device=None) -> dict:
    """The encoder at the deepest task's depth and the CTC head, laid out
    (and named) like the JAX package's ctc.init, on `device` (default: the
    CUDA card). cfg.num_layers['char'] names the depth that feeds the
    head."""
    device = resolve(device)
    attn_size = cfg.encoder.hidden_size * (2 if cfg.encoder.bi_dir else 1)
    return {
        "encoder": encoder_lib.init(gen, cfg.encoder,
                                    max(cfg.num_layers.values()),
                                    cfg.feat_length, device=device),
        "ctc_head": dense_params(gen, attn_size, vocab_size, device=device),
    }


def logits(params: dict, cfg: Seq2SeqConfig, feats: torch.Tensor,
           feat_lens: torch.Tensor, *, train: bool = False, gen=None,
           noise: dict | None = None, compute_dtype=None):
    """(per-frame logits [B, T_enc, V], encoder lengths [B]). In training
    the encoder's dropout takes noise["encoder"] ({depth: bool keep-mask})
    where given, else draws it from `gen`."""
    _check_dtype(compute_dtype)
    attn_states, _, enc_lens = seq2seq.encode(
        params, cfg, feats, feat_lens, train=train, gen=gen,
        drop_masks=(noise or {}).get("encoder"))
    depth = cfg.num_layers["char"]
    return dense(params["ctc_head"], attn_states[depth]), enc_lens[depth]


def loss(params: dict, cfg: Seq2SeqConfig, batch: dict, *,
         train: bool = False, gen=None, noise: dict | None = None,
         compute_dtype=None) -> torch.Tensor:
    """Mean CTC loss. batch: logmel/logmel_len plus `labels` [B, L] (token
    ids, 0-padded, no <go>/<eos>) and `label_lens` [B], tensors on the
    parameters' device. The reference's encoder draws its dropout from the
    step's key itself (fold_in(rng, depth))."""
    lg, enc_lens = logits(params, cfg, batch["logmel"], batch["logmel_len"],
                          train=train, gen=gen, noise=noise,
                          compute_dtype=compute_dtype)
    return ctc_loss_mean(lg, enc_lens, batch["labels"], batch["label_lens"],
                         blank_id=BLANK_ID)


def best_path_from_logits(lg: torch.Tensor,
                          enc_lens: torch.Tensor) -> torch.Tensor:
    """Best-path collapse of per-frame logits [B, T, V]: argmax (the first
    maximum), repeats collapsed, blanks and frames past each length
    dropped. Returns [B, T] token ids left-packed (a stable sort), 0-padded
    (int32)."""
    B, T, _ = lg.shape
    ids = torch.argmax(lg, dim=-1)                               # [B, T]
    valid = (torch.arange(T, device=lg.device)[None, :]
             < enc_lens.to(lg.device).long()[:, None])
    prev = torch.cat([torch.full((B, 1), -1, dtype=ids.dtype,
                                 device=ids.device), ids[:, :-1]], dim=1)
    keep = (ids != BLANK_ID) & (ids != prev) & valid
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    packed = torch.gather(ids, 1, order)
    return torch.where(torch.gather(keep, 1, order), packed, 0).int()


@torch.no_grad()
def greedy_decode(params: dict, cfg: Seq2SeqConfig, feats: torch.Tensor,
                  feat_lens: torch.Tensor, *,
                  compute_dtype=None) -> torch.Tensor:
    """Best-path decode: features -> token ids [B, T_enc], left-packed,
    0-padded."""
    lg, enc_lens = logits(params, cfg, feats, feat_lens,
                          compute_dtype=compute_dtype)
    return best_path_from_logits(lg, enc_lens)
