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

Two routes, chosen from the shapes as the reference chooses
(`beam_decode`, `takes_mega`):
- B <= 2 and beam size k <= 16 (the reference's own gates for its
  whole-search megakernel), within the Hopper kernel's own limits
  (`kernels/beam_mega.fits`: k*V <= 8192, at most 8 decoder layers): the
  whole search in one launch of kernel #15 (`kernels/beam_mega.py`);
- otherwise `beam_decode_steps`, a step at a time: kernel B (cells), the
  additive attention in plain PyTorch, kernel C (output projections +
  log_softmax) and kernel D (selection), the state bookkeeping around them
  in plain PyTorch: `kernels/beam_mega.search`, the loop that is #15's
  plain version when it is given the plain versions of B, C and D. Where
  E2E_ASR_FUSED_ATTN opts in (`attn_output.attn_output_fits`), kernel #13
  takes the attention and C's place, as the reference's
  `_dec_step_fused`.
Both routes take LSTM and GRU decoders.
One-pass joint CTC/attention decoding (a `ctc_scorer`,
eval/ctc_prefix.CTCPrefixScorer, with beam_cfg.joint_ctc > 0) takes the
per-step route at every batch size, as the reference's gate keeps it off
its megakernel: each step also runs kernel #16 through the scorer.

Not ported (each raises NotImplementedError naming its ROADMAP.md item):
RNN-LM shallow fusion, internal-LM subtraction, contextual biasing, the
coverage penalty, n-best output and the transformer decoder.
"""
from __future__ import annotations

import torch

from e2e_asr_tpu_torch.kernels import (attn_output, beam_mega, beam_select,
                                       dec_step)
from e2e_asr_tpu_torch.models import attn_decoder
from e2e_asr_tpu_torch.config import BeamConfig, DecoderConfig


def check_supported(dec_cfg: DecoderConfig, beam_cfg: BeamConfig, *,
                    lm_params=None, return_nbest: bool = False,
                    bias=None) -> None:
    attn_decoder.check_supported(dec_cfg)
    todo = "is not ported yet (ROADMAP.md Queue 1, 'Decode features')"
    if lm_params is not None or beam_cfg.lm_weight != 0.0:
        raise NotImplementedError(f"RNN-LM shallow fusion {todo}")
    if beam_cfg.ilm_weight != 0.0:
        raise NotImplementedError(f"internal-LM subtraction {todo}")
    if bias is not None:
        raise NotImplementedError(f"contextual biasing {todo}")
    if beam_cfg.apply_cov_penalty and beam_cfg.cov_penalty != 0.0:
        raise NotImplementedError(f"the coverage penalty {todo}")
    if return_nbest:
        raise NotImplementedError(f"n-best output {todo}")


def takes_mega(dec_params: dict, beam_cfg: BeamConfig, batch: int,
               joint: bool = False) -> bool:
    """Whether `beam_decode` takes kernel #15's route for a batch of this
    size: B <= 2 and k <= 16, shapes within the kernel's limits, and no
    joint CTC scoring."""
    return (not joint and batch <= 2 and beam_cfg.beam_size <= 16
            and beam_mega.fits(beam_cfg.beam_size,
                               dec_params["embedding"].shape[0],
                               len(dec_params["dec_cells"])))


def beam_decode(dec_params: dict, dec_cfg: DecoderConfig,
                beam_cfg: BeamConfig, enc_states: torch.Tensor,
                enc_lens: torch.Tensor, lm_params: dict | None = None,
                return_nbest: bool = False, ctc_scorer=None, bias=None):
    """Batched beam search.

    dec_params: char decoder params (models/attn_decoder.init layout);
    enc_states [B, T_enc, H_enc] float32; enc_lens [B]; ctc_scorer: an
    eval/ctc_prefix.CTCPrefixScorer of the same batch, which joint
    decoding (beam_cfg.joint_ctc > 0) reads.
    Returns (tokens [B, max_steps] int64, lens [B] int64, scores [B] f32).
    """
    check_supported(dec_cfg, beam_cfg, lm_params=lm_params,
                    return_nbest=return_nbest, bias=bias)
    joint = ctc_scorer is not None and beam_cfg.joint_ctc > 0.0
    if takes_mega(dec_params, beam_cfg, enc_states.shape[0], joint=joint):
        ctx = attn_decoder.make_attn_context(dec_params, enc_states,
                                             enc_lens)
        return beam_mega.beam_decode_mega(
            dec_params, dec_cfg, beam_cfg, ctx.enc_states,
            ctx.hidden_features, ctx.mask)
    return beam_decode_steps(dec_params, dec_cfg, beam_cfg, enc_states,
                             enc_lens, ctc_scorer=ctc_scorer)


def beam_decode_steps(dec_params: dict, dec_cfg: DecoderConfig,
                      beam_cfg: BeamConfig, enc_states: torch.Tensor,
                      enc_lens: torch.Tensor, ctc_scorer=None):
    """The per-step route of `beam_decode`, at any batch size: the same
    arguments (of the decode features, only the joint CTC scorer) and
    results. Each step is kernels B (#11), C (#12) and D (#14) around the
    attention, or B, #13 and D where `attn_output_fits` admits #13, and
    with a scorer kernel #16 (kernels/beam_mega.py `search`)."""
    check_supported(dec_cfg, beam_cfg)
    ctx = attn_decoder.make_attn_context(dec_params, enc_states, enc_lens)
    B, T, Henc = ctx.enc_states.shape
    fused_attn = attn_output.attn_output_fits(
        B, beam_cfg.beam_size, T, ctx.hidden_features.shape[-1], Henc)
    return beam_mega.search(
        dec_params, dec_cfg, beam_cfg, ctx.enc_states, ctx.hidden_features,
        ctx.mask, cells=dec_step.cells_fused, output=dec_step.output_fused,
        select=beam_select.beam_select,
        attn=attn_output.attn_output_fused if fused_attn else None,
        scorer=ctc_scorer if beam_cfg.joint_ctc > 0.0 else None)
