"""Greedy decoding evaluators (port of e2e_asr_tpu/eval/greedy.py):
batched decode, detokenization, filler filtering, the edit distance, and
the gold / raw / decoded files.

- `GreedyEvaluator`, the attention family: greedy decode with early exit
  (models/seq2seq.apply_greedy: the encoder on its kernels, each step on
  kernels B and C, or B and #13 where E2E_ASR_FUSED_ATTN opts in; LSTM or
  GRU decoders);
- `TransducerEvaluator`, the transducer family: greedy decode at beam size
  1 (models/transducer.greedy_decode), beam search above
  (eval/transducer_beam.py);
- `CTCEvaluator`, the CTC family: best path at beam size 1
  (models/ctc.greedy_decode), the prefix beam search above
  (eval/ctc_beam.py).

Not ported (each raises NotImplementedError naming its ROADMAP.md item):
the mesh (data-parallel decode), and the CTC and transducer families'
n-best output, LM rescoring, LM fusion, ILM subtraction and biasing.
Params are float32: the port's loaders take no int8-quantized tree, and
bf16 compute raises in the Trainer.
"""
from __future__ import annotations

import os

import torch

from e2e_asr_tpu_torch.config import Seq2SeqConfig
from e2e_asr_tpu_torch.core.checkpoint import to_device
from e2e_asr_tpu_torch.core.device import resolve
from e2e_asr_tpu_torch.data import text
from e2e_asr_tpu_torch.eval import score as score_lib
from e2e_asr_tpu_torch.eval import ctc_beam, transducer_beam
from e2e_asr_tpu_torch.eval.score import WerAccumulator
from e2e_asr_tpu_torch.models import attn_decoder, ctc, seq2seq, transducer


class GreedyEvaluator:
    # "word" = the reference's filler-filtered WER; "char" = CER over the
    # same filtered text (spaces included as symbols).
    score_unit = "word"

    def __init__(self, cfg: Seq2SeqConfig, rev_vocab: list[str],
                 out_dir: str, *, file_prefix: str = "asr", mesh=None,
                 device=None):
        """Decodes on `device` (default: the CUDA card; raises without
        one)."""
        seq2seq.check_attention(cfg)
        attn_decoder.check_supported(cfg.decoders["char"])
        self._setup(cfg, rev_vocab, out_dir, file_prefix, mesh, device)

    def _setup(self, cfg, rev_vocab, out_dir, file_prefix, mesh, device):
        if mesh is not None:
            raise NotImplementedError("the data-parallel decode mesh is not "
                                      "ported yet (ROADMAP.md Queue 1, "
                                      "'Parallelism last')")
        self.cfg = cfg
        self.rev_vocab = rev_vocab
        self.out_dir = out_dir
        self.file_prefix = file_prefix
        self.device = resolve(device)

    def __call__(self, params, batches, *, write_files: bool = True) -> float:
        """The filler-filtered WER over `batches` (an iterable of dataset
        batches with `valid` masks); writes gold_, raw_ and decoded_
        {file_prefix}.txt into out_dir."""
        acc = WerAccumulator()
        os.makedirs(self.out_dir, exist_ok=True)
        paths = [os.path.join(self.out_dir, f"{kind}_{self.file_prefix}.txt")
                 for kind in ("gold", "raw", "decoded")]
        files = [open(p, "w") for p in paths] if write_files else []
        params = to_device(params, self.device)
        try:
            for batch in batches:
                feats = torch.as_tensor(batch["logmel"], dtype=torch.float32,
                                        device=self.device)
                lens = torch.as_tensor(batch["logmel_len"],
                                       device=self.device)
                ids = self._decode(params, feats, lens).cpu().numpy()
                for i in range(ids.shape[0]):
                    if not batch["valid"][i]:
                        continue
                    gold_sent = text.ids_to_sentence(batch["char"][i, 1:],
                                                     self.rev_vocab)
                    hyp_sent = text.ids_to_sentence(ids[i], self.rev_vocab)
                    raw_words, hyp_words = text.get_relevant_words(hyp_sent)
                    _, gold_words = text.get_relevant_words(gold_sent)
                    score_lib.accumulate(acc, hyp_words, gold_words,
                                         self.score_unit)
                    if write_files:
                        uid = batch["utt_ids"][i]
                        for f, words in zip(files, (gold_words, raw_words,
                                                    hyp_words)):
                            f.write(f"{uid}\t{' '.join(words)}\n")
        finally:
            for f in files:
                f.close()
        print(f"Total sentences: {acc.sentences}")
        if write_files:
            print(f"Output at: {paths[1]}")
        print(f"Score: {acc.score:f}")
        return acc.score

    def _decode(self, params, feats, lens):
        """Token ids [B, T_out] of a batch on the device."""
        return seq2seq.apply_greedy(params, self.cfg, feats, lens,
                                    task="char", go_id=text.GO_ID)


class TransducerEvaluator(GreedyEvaluator):
    """The same scoring and files over the transducer family: batched
    greedy decode at beam_size 1, beam search otherwise; both return
    emission-ordered, left-packed token ids."""

    def __init__(self, cfg: Seq2SeqConfig, rev_vocab: list[str],
                 out_dir: str, *, compute_dtype=None, beam_size: int = 1,
                 file_prefix: str = "asr", lm_params=None,
                 lm_weight: float = 0.0, ilm_weight: float = 0.0,
                 lm_rescore: float = 0.0, bias=None, nbest: int = 1,
                 mesh=None, device=None):
        """Decodes on `device` (default: the CUDA card; raises without
        one)."""
        todo = "is not ported yet (ROADMAP.md Queue 1, 'Decode features')"
        if nbest > 1:
            raise NotImplementedError(f"transducer n-best output {todo}")
        if lm_rescore != 0.0:
            raise NotImplementedError(f"transducer lm_rescore {todo}")
        transducer_beam.check_supported(
            lm_params=lm_params, lm_weight=lm_weight, ilm_weight=ilm_weight,
            bias=bias, compute_dtype=compute_dtype)
        self.beam_size = beam_size
        self._setup(cfg, rev_vocab, out_dir, file_prefix, mesh, device)

    def _decode(self, params, feats, lens):
        if self.beam_size > 1:
            return transducer_beam.transducer_beam_search(
                params, self.cfg, feats, lens, beam_size=self.beam_size)[0]
        return transducer.greedy_decode(params, self.cfg, feats, lens)


class CTCEvaluator(GreedyEvaluator):
    """The same scoring and files over the CTC family: best path at
    beam_size 1, the prefix beam search otherwise; both return left-packed
    token ids. lm_weight without lm_params, or with lm_rescore, raises
    ValueError as in the JAX package."""

    def __init__(self, cfg: Seq2SeqConfig, rev_vocab: list[str],
                 out_dir: str, *, compute_dtype=None, beam_size: int = 1,
                 file_prefix: str = "asr", lm_params=None,
                 lm_weight: float = 0.0, lm_rescore: float = 0.0,
                 bias=None, nbest: int = 1, mesh=None, device=None):
        """Decodes on `device` (default: the CUDA card; raises without
        one)."""
        if (lm_weight != 0.0 or lm_rescore != 0.0) and lm_params is None:
            raise ValueError("CTC LM fusion/rescoring needs -lm_path "
                             "(no internal shared LM in this family)")
        if lm_weight != 0.0 and lm_rescore != 0.0:
            raise ValueError("-lm_rescore (second pass) and -lm_weight "
                             "(per-step fusion) are two LM applications; "
                             "pick one")
        if nbest > 1:
            raise NotImplementedError("CTC n-best output is not ported yet "
                                      "(ROADMAP.md Queue 1, 'Decode "
                                      "features')")
        ctc_beam.check_supported(lm_params=lm_params, lm_weight=lm_weight,
                                 bias=bias, lm_rescore=lm_rescore)
        ctc._check_dtype(compute_dtype)
        self.beam_size = beam_size
        self._setup(cfg, rev_vocab, out_dir, file_prefix, mesh, device)

    def _decode(self, params, feats, lens):
        if self.beam_size > 1:
            return ctc_beam.ctc_beam_search(params, self.cfg, feats, lens,
                                            beam_size=self.beam_size)[0]
        return ctc.greedy_decode(params, self.cfg, feats, lens)
