"""Beam-search decoding entry point: encoder + batched beam search (port of
e2e_asr_tpu/eval/beam_eval.py `make_beam_decoder`, attention family)."""
from __future__ import annotations

import torch

from e2e_asr_tpu_torch.shared import BeamConfig, Seq2SeqConfig
from e2e_asr_tpu_torch.eval.beam import beam_decode, check_supported
from e2e_asr_tpu_torch.models import seq2seq


def make_beam_decoder(cfg: Seq2SeqConfig, beam_cfg: BeamConfig, *,
                      compute_dtype=None, lm_params=None, bias=None,
                      nbest: int = 1):
    """decode(params, batch) -> (tokens [B, max_steps], lens [B],
    scores [B]) for the attention family, nbest=1, no LM.

    batch: {"logmel": [B, T, feat] float32, "logmel_len": [B]} as numpy
    arrays or tensors; they are moved to the device of the parameters.
    """
    seq2seq.check_supported(cfg)
    dec_cfg = cfg.decoders["char"]
    check_supported(dec_cfg, beam_cfg, lm_params=lm_params, bias=bias,
                    return_nbest=nbest > 1)
    if beam_cfg.lm_rescore != 0.0:
        raise NotImplementedError("second-pass LM rescoring is not ported "
                                  "yet (ROADMAP.md Queue 1, 'Decode "
                                  "features')")
    if compute_dtype is not None:
        raise NotImplementedError("bf16 compute is not ported yet "
                                  "(ROADMAP.md Queue 1, 'Decode features')")
    depth = cfg.num_layers["char"]

    @torch.no_grad()
    def decode(params, batch):
        dev = params["decoder_char"]["embedding"].device
        feats = torch.as_tensor(batch["logmel"], dtype=torch.float32,
                                device=dev)
        feat_lens = torch.as_tensor(batch["logmel_len"], device=dev)
        attn_states, _, enc_lens = seq2seq.encode(params, cfg, feats,
                                                  feat_lens)
        return beam_decode(params["decoder_char"], dec_cfg, beam_cfg,
                           attn_states[depth], enc_lens[depth])

    return decode
