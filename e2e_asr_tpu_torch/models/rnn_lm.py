"""RNN language model whose parameters are the char decoder's (port of
e2e_asr_tpu/models/rnn_lm.py: `shared_lm_params`, `apply`, `loss`).

The reference ties the LM's LSTM and softmax to the char decoder's
internal "LM LSTM" and OutputProjection. Here, as in the JAX package, the
sharing is explicit: the LM reads the SAME tensors of
params["decoder_char"] (lm_cell, output_proj, embedding and simple_proj
where present), so a step of the LM task updates the decoder's weights.
The LSTM runs through kernel #3 (core/rnn.lstm_scan).

Not ported: the transformer decoder's tied LM (ROADMAP.md Queue 1,
'Transformer family') and the shallow-fusion helpers (Queue 1, 'Decode
features'). A GRU char decoder has no LM task: the JAX package's LM runs
its tied cell through the LSTM scan (rnn_lm.py:180), which a GRU cell's
leaves do not fit, and the port raises ValueError there (`check_cell`).
"""
from __future__ import annotations

import torch

from e2e_asr_tpu_torch.config import LMConfig
from e2e_asr_tpu_torch.core import losses, rnn
from e2e_asr_tpu_torch.core.layers import dense, dropout, dropout_mask


GRU_LM = ("the LM task needs an LSTM char decoder: the JAX package has no "
          "GRU LM task either (its tied LM runs the decoder's LM cell "
          "through the LSTM scan, models/rnn_lm.py:180)")


def check_cell(use_lstm: bool) -> None:
    """Raise ValueError for a GRU char decoder, which has no LM task."""
    if not use_lstm:
        raise ValueError(GRU_LM)


def shared_lm_params(params: dict) -> dict:
    """The char-decoder tensors the LM shares (not copies)."""
    dec = params["decoder_char"]
    if "lm_cell" not in dec:
        raise NotImplementedError("the transformer decoder's tied LM is not "
                                  "ported yet (ROADMAP.md Queue 1, "
                                  "'Transformer family')")
    check_cell("gates" not in dec["lm_cell"])
    out = {"lstm": dec["lm_cell"], "output_proj": dec["output_proj"],
           "embedding": dec["embedding"]}
    if "simple_proj" in dec:
        out["simple_proj"] = dec["simple_proj"]
    return out


def apply(params: dict, cfg: LMConfig, token_ids: torch.Tensor,
          seq_len: torch.Tensor, *, train: bool = False,
          gen: torch.Generator | None = None, noise=None) -> torch.Tensor:
    """LM forward: token_ids [T, B] time-major (row 0 is <go>); the model
    reads rows [0, T-1) and predicts rows [1, T). Returns logits
    [T-1, B, V]. In training the LSTM's output takes dropout with keep
    probability cfg.out_prob: `noise` is its bool keep-mask [T-1, B, H], or
    None to draw it from `gen`."""
    lm = shared_lm_params(params)
    emb_in = lm["embedding"][token_ids[:-1].long()]           # [T-1, B, emb]
    outputs = rnn.lstm_scan(lm["lstm"], emb_in, seq_len)
    if train and cfg.out_prob < 1.0:
        mask = noise if noise is not None else dropout_mask(
            gen, outputs.shape, cfg.out_prob, outputs.device)
        outputs = dropout(outputs, cfg.out_prob, mask=mask.to(outputs.device))
    if "simple_proj" in lm:
        outputs = dense(lm["simple_proj"], outputs)
    return dense(lm["output_proj"], outputs)


def loss(params: dict, cfg: LMConfig, token_ids: torch.Tensor,
         seq_len: torch.Tensor, *, train: bool = True,
         gen: torch.Generator | None = None, noise=None,
         valid: torch.Tensor | None = None) -> torch.Tensor:
    """Shifted-target CE with the reference's normalization. valid:
    optional [B] row validity of a padded tail batch (data/lm.py)."""
    logits = apply(params, cfg, token_ids, seq_len, train=train, gen=gen,
                   noise=noise)
    targets, _ = losses.shifted_targets(token_ids, seq_len)
    return losses.cross_entropy_loss(logits, targets, seq_len,
                                     weights=valid)
