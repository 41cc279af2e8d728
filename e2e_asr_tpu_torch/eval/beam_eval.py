"""Beam-search decoding and evaluation: encoder + batched beam search +
WER (port of e2e_asr_tpu/eval/beam_eval.py `make_beam_decoder` and
`BeamEvaluator`, attention family, with one-pass joint CTC/attention
decoding of a hybrid checkpoint)."""
from __future__ import annotations

import os

import torch

from e2e_asr_tpu_torch.config import BeamConfig, Seq2SeqConfig
from e2e_asr_tpu_torch.core.checkpoint import to_device
from e2e_asr_tpu_torch.core.device import resolve
from e2e_asr_tpu_torch.core.layers import dense
from e2e_asr_tpu_torch.data import text
from e2e_asr_tpu_torch.eval import score as score_lib
from e2e_asr_tpu_torch.eval.score import WerAccumulator
from e2e_asr_tpu_torch.eval.beam import beam_decode, check_supported
from e2e_asr_tpu_torch.eval.ctc_prefix import CTCPrefixScorer
from e2e_asr_tpu_torch.models import seq2seq


def make_beam_decoder(cfg: Seq2SeqConfig, beam_cfg: BeamConfig, *,
                      compute_dtype=None, lm_params=None, bias=None,
                      nbest: int = 1):
    """decode(params, batch) -> (tokens [B, max_steps], lens [B],
    scores [B]) for the attention family, nbest=1, no LM. With
    beam_cfg.joint_ctc > 0 the hybrid checkpoint's CTC head scores the
    same encoder pass (eval/ctc_prefix.CTCPrefixScorer, pre-pruned to
    beam_cfg.ctc_pre_beam candidates where that is set); a tree without
    `ctc_head` raises ValueError.

    batch: {"logmel": [B, T, feat] float32, "logmel_len": [B]} as numpy
    arrays or tensors; they are moved to the device of the parameters.
    """
    seq2seq.check_attention(cfg)
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
    use_joint = beam_cfg.joint_ctc > 0.0

    @torch.no_grad()
    def decode(params, batch):
        if use_joint and "ctc_head" not in params:
            raise ValueError("-joint_ctc needs a hybrid checkpoint "
                             "(train with -ctc_weight > 0)")
        dev = params["decoder_char"]["embedding"].device
        feats = torch.as_tensor(batch["logmel"], dtype=torch.float32,
                                device=dev)
        feat_lens = torch.as_tensor(batch["logmel_len"], device=dev)
        attn_states, _, enc_lens = seq2seq.encode(params, cfg, feats,
                                                  feat_lens)
        scorer = None
        if use_joint:
            scorer = CTCPrefixScorer(
                dense(params["ctc_head"], attn_states[depth]),
                enc_lens[depth], pre_beam=beam_cfg.ctc_pre_beam or None)
        return beam_decode(params["decoder_char"], dec_cfg, beam_cfg,
                           attn_states[depth], enc_lens[depth],
                           ctc_scorer=scorer)

    return decode


class BeamEvaluator:
    """Beam-search evaluation (port of e2e_asr_tpu/eval/beam_eval.py
    `BeamEvaluator`, attention family): the encoder and the batched beam
    search (`make_beam_decoder`: kernel #15's route at B <= 2, the per-step
    route above and for joint CTC/attention decoding, `joint_ctc`),
    detokenization, filler filtering and the edit distance;
    writes gold.txt and raw_{beam_size}.txt into out_dir and prints the
    score with its insertion / deletion / substitution breakdown.

    Not ported (NotImplementedError naming the ROADMAP.md item): n-best
    CTC rescoring (`ctc_rescore`), n-best output, second-pass LM rescoring
    (`lm_rescore`, raised by make_beam_decoder) and the data-parallel
    decode mesh."""

    score_unit = "word"      # "char" = CER (see GreedyEvaluator.score_unit)

    def __init__(self, cfg: Seq2SeqConfig, beam_cfg: BeamConfig,
                 rev_vocab: list[str], out_dir: str, *, compute_dtype=None,
                 lm_params=None, bias=None, nbest: int = 1, mesh=None,
                 device=None):
        """Decodes on `device` (default: the CUDA card; raises without
        one)."""
        if mesh is not None:
            raise NotImplementedError("the data-parallel decode mesh is not "
                                      "ported yet (ROADMAP.md Queue 1, "
                                      "'Parallelism last')")
        if beam_cfg.ctc_rescore > 0:
            raise NotImplementedError("n-best CTC rescoring is not ported "
                                      "yet (ROADMAP.md Queue 1, 'CTC "
                                      "family')")
        self.beam_cfg = beam_cfg
        self.rev_vocab = rev_vocab
        self.out_dir = out_dir
        self.device = resolve(device)
        self._decode = make_beam_decoder(cfg, beam_cfg,
                                         compute_dtype=compute_dtype,
                                         lm_params=lm_params, bias=bias,
                                         nbest=nbest)

    def __call__(self, params, batches, *, write_files: bool = True) -> float:
        """The filler-filtered WER over `batches` (an iterable of dataset
        batches with `valid` masks)."""
        acc = WerAccumulator()
        os.makedirs(self.out_dir, exist_ok=True)
        gold_path = os.path.join(self.out_dir, "gold.txt")
        raw_path = os.path.join(self.out_dir,
                                f"raw_{self.beam_cfg.beam_size}.txt")
        files = ([open(gold_path, "w"), open(raw_path, "w")] if write_files
                 else [])
        params = to_device(params, self.device)
        try:
            for batch in batches:
                tokens, lens, _ = self._decode(params, batch)
                tokens, lens = tokens.cpu().numpy(), lens.cpu().numpy()
                for i in range(tokens.shape[0]):
                    if not batch["valid"][i]:
                        continue
                    hyp_sent = text.ids_to_sentence(tokens[i, : lens[i]],
                                                    self.rev_vocab)
                    gold_sent = text.ids_to_sentence(batch["char"][i, 1:],
                                                     self.rev_vocab)
                    raw_words, hyp_words = text.get_relevant_words(hyp_sent)
                    _, gold_words = text.get_relevant_words(gold_sent)
                    score_lib.accumulate(acc, hyp_words, gold_words,
                                         self.score_unit)
                    if write_files:
                        uid = batch["utt_ids"][i]
                        files[0].write(f"{uid}\t{' '.join(gold_words)}\n")
                        files[1].write(f"{uid}\t{' '.join(raw_words)}\n")
        finally:
            for f in files:
                f.close()
        if write_files:
            print(f"Output at: {raw_path}")
        print(f"Score: {acc.score:f}")
        print(f"Insertion: {acc.insertions}, Deletion: {acc.deletions}, "
              f"Substitution: {acc.substitutions}")
        return acc.score
