"""Bahdanau-attention LSTM decoder: parameters and attention (port of
e2e_asr_tpu/models/attn_decoder.py, the parts the beam search uses).

Per-step structure, order preserved from the reference:
  internal "LM LSTM" on the previous token embedding
  -> optional SimpleProjection (when lm_hidden_size != hidden_size_dec)
  -> InputProjection merges [lm_output, previous context] into the cell input
  -> decoder LSTM cells (1..N layers)
  -> attention over the precomputed W*h_enc with a masked softmax
  -> AttnProjection of [query, context] -> OutputProjection logits.
The attention query is the top cell's **c** state. The step itself is
kernels B and C around `attention` (eval/beam.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from e2e_asr_tpu_torch.shared import DecoderConfig
from e2e_asr_tpu_torch.core import cells
from e2e_asr_tpu_torch.core.layers import (dense, dense_params,
                                           glorot_uniform, uniform_init)

NEG_INF = -1e30


class AttnContext(NamedTuple):
    """Precomputed encoder-side attention quantities."""
    enc_states: torch.Tensor       # [B, T_enc, H_enc]
    hidden_features: torch.Tensor  # [B, T_enc, A] = enc_states @ attn_w
    mask: torch.Tensor             # [B, T_enc] float 1/0 validity


def check_supported(cfg: DecoderConfig) -> None:
    if cfg.decoder_type != "rnn":
        raise NotImplementedError("the transformer decoder is not ported yet "
                                  "(ROADMAP.md Queue 1, 'Transformer family')")
    if not cfg.use_lstm:
        raise NotImplementedError("GRU decoders are not ported yet "
                                  "(ROADMAP.md Queue 1, 'GRU option')")


def init(gen: torch.Generator, cfg: DecoderConfig, attn_size: int, *,
         device=None) -> dict:
    """attn_size: encoder output width (2*hidden for bidir encoders)."""
    check_supported(cfg)
    hid = cfg.hidden_size_dec
    params: dict = {
        "embedding": uniform_init(gen, (cfg.vocab_size, cfg.emb_size), 1.0,
                                  device=device),
        "lm_cell": cells.lstm_init(gen, cfg.emb_size, cfg.lm_hidden_size,
                                   device=device),
        "input_proj": dense_params(gen, hid + attn_size, cfg.emb_size,
                                   device=device),
        "attn_w": glorot_uniform(gen, (attn_size, cfg.attention_vec_size),
                                 device=device),
        "attn_v": glorot_uniform(gen, (cfg.attention_vec_size,),
                                 device=device),
        "attn_query": dense_params(gen, hid, cfg.attention_vec_size,
                                   device=device),
        "attn_proj": dense_params(gen, hid + attn_size, hid, device=device),
        "output_proj": dense_params(gen, hid, cfg.vocab_size, device=device),
    }
    if cfg.ind_softmax:
        params["output_proj_ind"] = dense_params(gen, hid, cfg.vocab_size,
                                                 device=device)
    if cfg.lm_hidden_size != hid:
        params["simple_proj"] = dense_params(gen, cfg.lm_hidden_size, hid,
                                             device=device)
    params["dec_cells"] = [
        cells.lstm_init(gen, cfg.emb_size if layer == 0 else hid, hid,
                        device=device)
        for layer in range(cfg.num_layers_dec)]
    return params


def make_attn_context(params: dict, enc_states: torch.Tensor,
                      enc_lens: torch.Tensor) -> AttnContext:
    """Precompute W*h_enc and the validity mask."""
    hidden_features = enc_states @ params["attn_w"]
    T_enc = enc_states.shape[1]
    mask = (torch.arange(T_enc, device=enc_states.device)[None, :]
            < enc_lens.to(enc_states.device).long()[:, None]).float()
    return AttnContext(enc_states, hidden_features, mask)


def alpha_context(params: dict, ctx: AttnContext, y: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention from a precomputed query projection y [B, k, A] over a
    beam axis k -> (context [B, k, H_enc], alpha [B, k, T_enc])."""
    s = torch.sum(params["attn_v"] * torch.tanh(
        ctx.hidden_features[:, None, :, :] + y[:, :, None, :]), dim=-1)
    s = torch.where(ctx.mask[:, None, :] > 0, s, torch.full_like(s, NEG_INF))
    alpha = torch.softmax(s, dim=-1)
    return torch.einsum("bkt,bth->bkh", alpha, ctx.enc_states), alpha


def attention(params: dict, ctx: AttnContext, query: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked Bahdanau attention for query [B, Q] -> (context [B, H_enc],
    alpha [B, T_enc])."""
    y = dense(params["attn_query"], query)
    context, alpha = alpha_context(params, ctx, y[:, None, :])
    return context[:, 0], alpha[:, 0]
