"""Batched beam search for the attention decoder (port of
e2e_asr_tpu/eval/beam.py, the subset the serving defaults use).

A static beam axis k over every utterance of the batch, at most max_steps
steps, stopping early once no hypothesis of the batch is live. Semantics
kept from the reference:
- the beam shrinks when a hypothesis emits <eos>: it moves to a k-slot
  finished buffer and is never displaced; later steps accept only
  k - #finished continuations;
- word_ins_penalty is applied per step to the cumulative score;
- the answer is the best-scoring member of finished ∪ live (ties to the
  first, finished before live).

One step is kernel B (cells), the additive attention in plain PyTorch,
kernel C (output projections + log_softmax) and kernel D (selection); the
state bookkeeping around them is plain PyTorch. Rows are flattened b-major
(row = b*k + j) for the kernels.

Not ported (each raises NotImplementedError naming its ROADMAP.md item):
RNN-LM shallow fusion, internal-LM subtraction, joint CTC decoding,
contextual biasing, the coverage penalty, n-best output and the
transformer decoder. The whole-search megakernel of the reference
(small batches) has no counterpart yet: every batch size runs this per-step
path (ROADMAP.md Queue 2, kernel #15).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from e2e_asr_tpu_torch.core import cells
from e2e_asr_tpu_torch.kernels import beam_select, dec_step
from e2e_asr_tpu_torch.kernels.beam_select import NEG_INF
from e2e_asr_tpu_torch.models import attn_decoder
from e2e_asr_tpu_torch.config import BeamConfig, DecoderConfig
from e2e_asr_tpu_torch.data.text import EOS_ID, GO_ID


class BeamState(NamedTuple):
    t: int                   # steps completed
    alive: torch.Tensor      # [B, k] bool
    scores: torch.Tensor     # [B, k] cumulative score (NEG_INF when dead)
    seqs: torch.Tensor       # [B, k, max_steps] int64
    dec_cell_states: tuple   # per decoder layer LSTMState of [B, k, H]
    dec_lm_state: cells.LSTMState  # internal decoder-LM state [B, k, Hl]
    context: torch.Tensor    # [B, k, H_enc]
    inputs: torch.Tensor     # [B, k, emb] next decoder-LM input embedding
    num_finished: torch.Tensor  # [B] int32
    fin_scores: torch.Tensor    # [B, k+1] (slot k is the drop slot)
    fin_seqs: torch.Tensor      # [B, k+1, max_steps]
    fin_lens: torch.Tensor      # [B, k+1] int64


def check_supported(dec_cfg: DecoderConfig, beam_cfg: BeamConfig, *,
                    lm_params=None, return_nbest: bool = False,
                    ctc_scorer=None, bias=None) -> None:
    attn_decoder.check_supported(dec_cfg)
    todo = "is not ported yet (ROADMAP.md Queue 1, 'Decode features')"
    if lm_params is not None or beam_cfg.lm_weight != 0.0:
        raise NotImplementedError(f"RNN-LM shallow fusion {todo}")
    if beam_cfg.ilm_weight != 0.0:
        raise NotImplementedError(f"internal-LM subtraction {todo}")
    if ctc_scorer is not None or beam_cfg.joint_ctc > 0.0:
        raise NotImplementedError("joint CTC/attention decoding is not "
                                  "ported yet (ROADMAP.md Queue 1, 'CTC "
                                  "family')")
    if bias is not None:
        raise NotImplementedError(f"contextual biasing {todo}")
    if beam_cfg.apply_cov_penalty and beam_cfg.cov_penalty != 0.0:
        raise NotImplementedError(f"the coverage penalty {todo}")
    if return_nbest:
        raise NotImplementedError(f"n-best output {todo}")


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + x.shape[2:])


def _gather_beam(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, k, ...] selected along the beam axis by idx [B, k]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _dec_step(params: dict, cfg: DecoderConfig, ctx: attn_decoder.AttnContext,
              state: BeamState):
    """One decoder step over the whole [B, k] beam: (new_cell_states,
    new_dec_lm_state, new_context, log_probs [B, k, V]), states [B, k, .]."""
    B, k = state.alive.shape
    def flat_state(s):
        return cells.LSTMState(_flat(s.c), _flat(s.h))
    new_lm, new_dec, y = dec_step.cells_fused(
        params, _flat(state.inputs), _flat(state.context),
        flat_state(state.dec_lm_state),
        tuple(flat_state(s) for s in state.dec_cell_states))
    query = new_dec[-1].c
    context, _ = attn_decoder.alpha_context(params, ctx, y.view(B, k, -1))
    logp = dec_step.output_fused(params, cfg, query,
                                 _flat(context).contiguous())
    unflat = lambda s: cells.LSTMState(s.c.view(B, k, -1),  # noqa: E731
                                       s.h.view(B, k, -1))
    return (tuple(unflat(s) for s in new_dec), unflat(new_lm), context,
            logp.view(B, k, -1))


def beam_decode(dec_params: dict, dec_cfg: DecoderConfig,
                beam_cfg: BeamConfig, enc_states: torch.Tensor,
                enc_lens: torch.Tensor, lm_params: dict | None = None,
                return_nbest: bool = False, ctc_scorer=None, bias=None):
    """Batched beam search.

    dec_params: char decoder params (models/attn_decoder.init layout);
    enc_states [B, T_enc, H_enc] float32; enc_lens [B].
    Returns (tokens [B, max_steps] int64, lens [B] int64, scores [B] f32).
    """
    check_supported(dec_cfg, beam_cfg, lm_params=lm_params,
                    return_nbest=return_nbest, ctc_scorer=ctc_scorer,
                    bias=bias)
    dev = enc_states.device
    B, _, H_enc = enc_states.shape
    k = beam_cfg.beam_size
    S = beam_cfg.max_steps
    penalty = beam_cfg.word_ins_penalty
    ctx = attn_decoder.make_attn_context(dec_params, enc_states, enc_lens)
    emb = dec_params["embedding"]
    zero = lambda h: cells.lstm_zero_state((B, k), h, device=dev)  # noqa: E731

    state = BeamState(
        t=0,
        alive=torch.zeros(B, k, dtype=torch.bool, device=dev).index_fill_(
            1, torch.tensor([0], device=dev), True),
        scores=torch.full((B, k), NEG_INF, device=dev).index_fill_(
            1, torch.tensor([0], device=dev), 0.0),
        seqs=torch.zeros(B, k, S, dtype=torch.long, device=dev),
        dec_cell_states=tuple(zero(dec_cfg.hidden_size_dec)
                              for _ in range(dec_cfg.num_layers_dec)),
        dec_lm_state=zero(dec_cfg.lm_hidden_size),
        context=torch.zeros(B, k, H_enc, device=dev),
        inputs=emb[torch.full((B, k), GO_ID, device=dev)],
        num_finished=torch.zeros(B, dtype=torch.int32, device=dev),
        fin_scores=torch.full((B, k + 1), NEG_INF, device=dev),
        fin_seqs=torch.zeros(B, k + 1, S, dtype=torch.long, device=dev),
        fin_lens=torch.zeros(B, k + 1, dtype=torch.long, device=dev),
    )
    b_idx = torch.arange(B, device=dev)[:, None]
    while state.t < S and bool(state.alive.any()):
        state = _beam_step(dec_params, dec_cfg, ctx, state, emb, b_idx,
                           penalty)

    live_scores = torch.where(state.alive, state.scores,
                              torch.full_like(state.scores, NEG_INF))
    all_scores = torch.cat([state.fin_scores[:, :k], live_scores], dim=1)
    all_seqs = torch.cat([state.fin_seqs[:, :k], state.seqs], dim=1)
    all_lens = torch.cat([state.fin_lens[:, :k],
                          torch.full((B, k), state.t, device=dev)], dim=1)
    best = torch.argmax(all_scores, dim=1)
    rows = torch.arange(B, device=dev)
    return all_seqs[rows, best], all_lens[rows, best], all_scores[rows, best]


def _beam_step(params, cfg, ctx, state: BeamState, emb, b_idx, penalty
               ) -> BeamState:
    B, k = state.alive.shape
    new_cells, new_lm, new_context, logp = _dec_step(params, cfg, ctx, state)
    sel = beam_select.beam_select(state.scores, logp, state.alive,
                                  state.num_finished, eos_id=EOS_ID)
    parent, token = sel["parent"].long(), sel["token"].long()
    order = sel["order"].long()
    fin_dest = sel["fin_dest"].long()
    slot_valid = sel["slot_valid"] > 0
    new_len = state.t + 1
    stored = sel["vals"] + penalty * new_len

    # Candidate sequences of all k ranks: the parent's sequence + token at t.
    cand_seqs = _gather_beam(state.seqs, parent)
    cand_seqs[:, :, state.t] = token

    # Finished buffer: newly finished in rank order; the rest land in the
    # drop slot k.
    fin_scores = state.fin_scores.clone()
    fin_scores[b_idx, fin_dest] = stored
    fin_seqs = state.fin_seqs.clone()
    fin_seqs[b_idx, fin_dest] = cand_seqs
    fin_lens = state.fin_lens.clone()
    fin_lens[b_idx, fin_dest] = new_len
    num_finished = state.num_finished + sel["fin_sel"].sum(
        dim=1, dtype=torch.int32)

    # Live beam: accepted non-<eos> candidates compacted in rank order.
    sel_parent = torch.gather(parent, 1, order)
    sel_token = torch.gather(token, 1, order)
    sel_scores = torch.gather(stored, 1, order)
    regather = lambda s: cells.LSTMState(  # noqa: E731
        _gather_beam(s.c, sel_parent), _gather_beam(s.h, sel_parent))
    safe_token = torch.where(slot_valid, sel_token,
                             torch.zeros_like(sel_token))
    return BeamState(
        t=new_len,
        alive=slot_valid,
        scores=torch.where(slot_valid, sel_scores,
                           torch.full_like(sel_scores, NEG_INF)),
        seqs=_gather_beam(cand_seqs, order),
        dec_cell_states=tuple(regather(s) for s in new_cells),
        dec_lm_state=regather(new_lm),
        context=_gather_beam(new_context, sel_parent),
        inputs=emb[safe_token],
        num_finished=num_finished,
        fin_scores=fin_scores,
        fin_seqs=fin_seqs,
        fin_lens=fin_lens,
    )
