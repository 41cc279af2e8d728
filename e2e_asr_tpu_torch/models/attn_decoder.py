"""Bahdanau-attention LSTM or GRU decoder (port of e2e_asr_tpu/models/
attn_decoder.py): parameters, attention, the step and the teacher-forced
training pass.

Per-step structure, order preserved from the reference:
  internal "LM LSTM" on the previous token embedding
  -> optional SimpleProjection (when lm_hidden_size != hidden_size_dec)
  -> InputProjection merges [lm_output, previous context] into the cell input
  -> decoder LSTM cells (1..N layers)
  -> attention over the precomputed W*h_enc with a masked softmax
  -> AttnProjection of [query, context] -> OutputProjection logits.
The attention query is the top cell's **c** state for LSTM cells and its
**h** for GRU cells (TF-1 GRUCell; reference decoder.py:64-82). At
inference the step is kernels B and C around the attention, or B and #13
with the attention folded in when E2E_ASR_FUSED_ATTN opts in (eval/beam.py,
and the greedy `apply_infer_early`), for either cell type. In training,
`apply_train` runs all steps with scheduled sampling (one coin per step
for the whole batch, gumbel-max sampling from the previous step's logits)
and dropout: as the plain scan over `step` on the CPU, and as the fused
training kernels on the card (kernels/dec_train.py for LSTM cells,
kernels/dec_train_gru.py for GRU).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from e2e_asr_tpu_torch.config import DecoderConfig
from e2e_asr_tpu_torch.core import cells
from e2e_asr_tpu_torch.core.layers import (dense, dense_params,
                                           glorot_uniform, uniform_init)
from e2e_asr_tpu_torch.data.text import EOS_ID
from e2e_asr_tpu_torch.kernels import (attn_output, dec_step, dec_train,
                                       dec_train_gru)


class AttnContext(NamedTuple):
    """Precomputed encoder-side attention quantities."""
    enc_states: torch.Tensor       # [B, T_enc, H_enc]
    hidden_features: torch.Tensor  # [B, T_enc, A] = enc_states @ attn_w
    mask: torch.Tensor             # [B, T_enc] float 1/0 validity


class DecState(NamedTuple):
    """Per-step decoder carry (everything but the next input embedding)."""
    cell_states: tuple             # LSTMState (GRU: h) per decoder layer
    lm_state: cells.LSTMState | torch.Tensor
    context: torch.Tensor          # [B, H_enc] previous attention context
    alpha: torch.Tensor            # [B, T_enc] previous attention weights


def check_supported(cfg: DecoderConfig) -> None:
    if cfg.decoder_type != "rnn":
        raise NotImplementedError("the transformer decoder is not ported yet "
                                  "(ROADMAP.md Queue 1, 'Transformer family')")


def init(gen: torch.Generator, cfg: DecoderConfig, attn_size: int, *,
         device=None) -> dict:
    """attn_size: encoder output width (2*hidden for bidir encoders)."""
    check_supported(cfg)
    hid = cfg.hidden_size_dec
    cell_init = cells.lstm_init if cfg.use_lstm else cells.gru_init
    params: dict = {
        "embedding": uniform_init(gen, (cfg.vocab_size, cfg.emb_size), 1.0,
                                  device=device),
        "lm_cell": cell_init(gen, cfg.emb_size, cfg.lm_hidden_size,
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
        cell_init(gen, cfg.emb_size if layer == 0 else hid, hid,
                  device=device)
        for layer in range(cfg.num_layers_dec)]
    return params


def make_attn_context(params: dict, enc_states: torch.Tensor,
                      enc_lens: torch.Tensor) -> AttnContext:
    """Precompute W*h_enc and the validity mask (enc_states made
    contiguous, as the decode kernels take them)."""
    enc_states = enc_states.contiguous()
    hidden_features = enc_states @ params["attn_w"]
    T_enc = enc_states.shape[1]
    mask = (torch.arange(T_enc, device=enc_states.device)[None, :]
            < enc_lens.to(enc_states.device).long()[:, None]).float()
    return AttnContext(enc_states, hidden_features, mask)


def attention(params: dict, ctx: AttnContext, query: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked Bahdanau attention for query [B, Q] -> (context [B, H_enc],
    alpha [B, T_enc])."""
    y = dense(params["attn_query"], query)
    return attn_output.attend(params, y, ctx.hidden_features, ctx.enc_states,
                              ctx.mask, k=1)


def zero_state(cfg: DecoderConfig, batch: int, ctx: AttnContext) -> DecState:
    dev = ctx.enc_states.device
    zero = cells.lstm_zero_state if cfg.use_lstm else cells.gru_zero_state
    return DecState(
        cell_states=tuple(zero((batch,), cfg.hidden_size_dec, device=dev)
                          for _ in range(cfg.num_layers_dec)),
        lm_state=zero((batch,), cfg.lm_hidden_size, device=dev),
        context=ctx.enc_states.new_zeros(batch, ctx.enc_states.shape[-1]),
        alpha=ctx.enc_states.new_zeros(batch, ctx.enc_states.shape[1]))


def _cell_step(cfg: DecoderConfig, cell_params: dict, x: torch.Tensor,
               state):
    if cfg.use_lstm:
        return cells.lstm_step(cell_params, x, state)
    return cells.gru_step(cell_params, x, state)


def _query_of(cfg: DecoderConfig, cell_states: tuple) -> torch.Tensor:
    """The attention query: the top cell's c (LSTM) or h (GRU)."""
    top = cell_states[-1]
    return top.c if cfg.use_lstm else top


def step(params: dict, cfg: DecoderConfig, ctx: AttnContext, state: DecState,
         lm_input: torch.Tensor, *, lm_drop_mask=None, inter_drop_masks=None
         ) -> tuple[DecState, torch.Tensor]:
    """One decoder step; lm_input [B, emb] is the previous token's
    embedding. Returns (new_state, logits [B, V]). Dropout masks (float,
    already scaled by 1/keep): lm_drop_mask on the LM cell's output,
    inter_drop_masks between stacked decoder cells."""
    lm_output, new_lm_state = _cell_step(cfg, params["lm_cell"], lm_input,
                                         state.lm_state)
    if lm_drop_mask is not None:
        lm_output = lm_output * lm_drop_mask
    if "simple_proj" in params:
        lm_output = dense(params["simple_proj"], lm_output)
    h = dense(params["input_proj"],
              torch.cat([lm_output, state.context], dim=-1))
    new_cell_states = []
    for layer, cell_params in enumerate(params["dec_cells"]):
        h, new_s = _cell_step(cfg, cell_params, h, state.cell_states[layer])
        if inter_drop_masks is not None and layer < len(
                params["dec_cells"]) - 1:
            h = h * inter_drop_masks[layer]
        new_cell_states.append(new_s)
    query = _query_of(cfg, new_cell_states)
    context, alpha = attention(params, ctx, query)
    proj = dense(params["attn_proj"], torch.cat([query, context], dim=-1))
    out_proj = params["output_proj_ind" if cfg.ind_softmax else "output_proj"]
    logits = dense(out_proj, proj)
    return DecState(tuple(new_cell_states), new_lm_state, context,
                    alpha), logits


def train_noise(gen: torch.Generator, cfg: DecoderConfig, steps: int, B: int,
                device) -> tuple:
    """The randomness of one training pass, drawn from `gen`:
    (flags [steps] 0/1 float, gumbel [steps, B, V], lm_masks
    [steps, B, lm_hidden] or None, inter_masks tuple of [steps, B, hidden]).
    flags and gumbel are None without scheduled sampling; the masks are
    float keep-masks scaled by 1/keep, None (and ()) without dropout. The
    reference draws the same distributions (attn_decoder.train_noise)."""
    def rand(*shape):
        return torch.rand(shape, generator=gen, device=gen.device).to(device)

    flags = gumbel = None
    if cfg.samp_prob > 0:
        flags = (rand(steps) >= 1.0 - cfg.samp_prob).float()
        u = rand(steps, B, cfg.vocab_size).clamp_min(1e-20)
        gumbel = -torch.log(-torch.log(u))
    lm_masks, inter_masks = None, ()
    keep = cfg.out_prob_dec
    if keep < 1.0:
        lm_masks = (rand(steps, B, cfg.lm_hidden_size) < keep).float() / keep
        inter_masks = tuple(
            (rand(steps, B, cfg.hidden_size_dec) < keep).float() / keep
            for _ in range(cfg.num_layers_dec - 1))
    return flags, gumbel, lm_masks, inter_masks


def apply_train(params: dict, cfg: DecoderConfig, dec_inputs: torch.Tensor,
                enc_states: torch.Tensor, enc_lens: torch.Tensor, *,
                gen: torch.Generator | None = None, noise=None
                ) -> torch.Tensor:
    """Teacher-forced training pass with scheduled sampling.

    dec_inputs: [T, B] time-major ids starting with <go>; enc_states
    [B, T_enc, H_enc]. noise: `train_noise`'s tuple, or None to draw it
    from `gen`. Returns logits [T-1, B, V] (logits[t] predicts
    dec_inputs[t+1]). On the card the fused training kernels run (#8/#9
    for LSTM cells, #10 for GRU); on the CPU the plain scan over `step`.
    """
    check_supported(cfg)
    T, B = dec_inputs.shape
    steps = T - 1
    dev = enc_states.device
    if noise is None:
        noise = train_noise(gen, cfg, steps, B, dev)
    flags, gumbel, lm_masks, inter_masks = noise
    if cfg.samp_prob <= 0:
        flags = gumbel = None
    else:
        flags, gumbel = flags.to(dev), gumbel.to(dev)
    if cfg.out_prob_dec >= 1.0:
        lm_masks, inter_masks = None, ()
    else:
        lm_masks = lm_masks.to(dev)
        inter_masks = tuple(m.to(dev) for m in inter_masks)
    emb = params["embedding"]
    emb_inputs = emb[dec_inputs.long()]                       # [T, B, emb]
    if dev.type == "cuda":
        fused = dec_train if cfg.use_lstm else dec_train_gru
        return fused.apply_train_fused(params, cfg, emb_inputs, enc_states,
                                       enc_lens, flags, gumbel, lm_masks)
    ctx = make_attn_context(params, enc_states, enc_lens)
    state = zero_state(cfg, B, ctx)
    lm_input = emb_inputs[0]
    logits_all = []
    for t in range(steps):
        state, logits = step(
            params, cfg, ctx, state, lm_input,
            lm_drop_mask=None if lm_masks is None else lm_masks[t],
            inter_drop_masks=(tuple(m[t] for m in inter_masks)
                              if lm_masks is not None else None))
        lm_input = emb_inputs[t + 1]
        if flags is not None and flags[t] >= 0.5:
            sampled = torch.argmax(logits.detach() + gumbel[t], dim=-1)
            lm_input = emb[sampled]
        logits_all.append(logits)
    return torch.stack(logits_all)


@torch.no_grad()
def apply_infer_early(params: dict, cfg: DecoderConfig, go_ids: torch.Tensor,
                      enc_states: torch.Tensor, enc_lens: torch.Tensor, *,
                      max_output: int, eos_id: int = EOS_ID
                      ) -> torch.Tensor:
    """Greedy decode with batch-wide early exit: argmax feedback from
    go_ids [B] until every row has emitted <eos> or max_output steps ran.
    Positions past a row's <eos> are <pad>. Returns ids [max_output, B].

    A step is the reference's fused inference step (`_fused_infer_step`),
    for LSTM or GRU cells: kernel B (dec_step.cells_fused), then the
    additive attention and kernel C (dec_step.output_fused), or kernel #13
    (attn_output.attn_output_fused) where `attn_output_fits` admits it;
    log-probs, argmax-equal to the logits. Their plain versions run for CPU
    tensors."""
    check_supported(cfg)
    B = go_ids.shape[0]
    emb = params["embedding"]
    ctx = make_attn_context(params, enc_states, enc_lens)
    T_enc, H_enc = ctx.enc_states.shape[1:]
    fused_attn = attn_output.attn_output_fits(
        B, 1, T_enc, params["attn_query"]["kernel"].shape[-1], H_enc)
    state = zero_state(cfg, B, ctx)
    lm_input = emb[go_ids.long()]
    done = torch.zeros(B, dtype=torch.bool, device=emb.device)
    out = torch.zeros(max_output, B, dtype=torch.long, device=emb.device)
    for t in range(max_output):
        new_lm, new_dec, y = dec_step.cells_fused(
            params, lm_input, state.context, state.lm_state,
            state.cell_states, use_lstm=cfg.use_lstm)
        query = _query_of(cfg, new_dec)
        if fused_attn:
            logp, context, alpha = attn_output.attn_output_fused(
                params, cfg, y, query, ctx.hidden_features, ctx.enc_states,
                ctx.mask, k=1)
        else:
            context, alpha = attn_output.attend(
                params, y, ctx.hidden_features, ctx.enc_states, ctx.mask, k=1)
            logp = dec_step.output_fused(params, cfg, query, context)
        ids = torch.where(done, 0, torch.argmax(logp, dim=-1))
        out[t] = ids
        done = done | (ids == eos_id)
        state = DecState(new_dec, new_lm, context, alpha)
        lm_input = emb[ids]
        if bool(done.all()):
            break
    return out
