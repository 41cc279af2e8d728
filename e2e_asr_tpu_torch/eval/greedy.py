"""Greedy decoding evaluator (port of e2e_asr_tpu/eval/greedy.py,
attention family): batched greedy decode with early exit
(models/seq2seq.apply_greedy: the encoder on its kernels, each step on
kernels B and C, or B and #13 where E2E_ASR_FUSED_ATTN opts in; LSTM or
GRU decoders), detokenization, filler filtering, the edit distance, and the
gold / raw / decoded files.

Not ported (each raises NotImplementedError naming its ROADMAP.md item):
the CTC and transducer families' evaluators (the constructor raises for
their configs) and the mesh (data-parallel decode). Params are float32:
the port's loaders take no int8-quantized tree, and bf16 compute raises in
the Trainer.
"""
from __future__ import annotations

import os

import torch

from e2e_asr_tpu_torch.config import Seq2SeqConfig
from e2e_asr_tpu_torch.core.checkpoint import to_device
from e2e_asr_tpu_torch.core.device import resolve
from e2e_asr_tpu_torch.data import text
from e2e_asr_tpu_torch.eval import score as score_lib
from e2e_asr_tpu_torch.eval.score import WerAccumulator
from e2e_asr_tpu_torch.models import attn_decoder, seq2seq


class GreedyEvaluator:
    # "word" = the reference's filler-filtered WER; "char" = CER over the
    # same filtered text (spaces included as symbols).
    score_unit = "word"

    def __init__(self, cfg: Seq2SeqConfig, rev_vocab: list[str],
                 out_dir: str, *, file_prefix: str = "asr", mesh=None,
                 device=None):
        """Decodes on `device` (default: the CUDA card; raises without
        one)."""
        seq2seq.check_supported(cfg)
        attn_decoder.check_supported(cfg.decoders["char"])
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
                ids = seq2seq.apply_greedy(params, self.cfg, feats, lens,
                                           task="char", go_id=text.GO_ID)
                ids = ids.cpu().numpy()                      # [B, T_out]
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

