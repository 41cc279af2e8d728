"""LM dataset: TFRecord char sequences -> fixed-shape batches (a copy of
e2e_asr_tpu/data/lm.py)."""
from __future__ import annotations

import numpy as np

from e2e_asr_tpu_torch.data import example as pb
from e2e_asr_tpu_torch.data import tfrecord
from e2e_asr_tpu_torch.data.speech import TOKEN_QUANTUM, _round_up


class LMDataset:
    def __init__(self, files: list[str], batch_size: int, *, seed: int = 10,
                 cap: int | None = None):
        self.seqs: list[np.ndarray] = []
        for path in sorted(files):
            for rec in tfrecord.read_records(path):
                _, seqs = pb.decode_sequence_example(rec)
                if seqs.get("cint"):
                    ids = np.concatenate(
                        [np.asarray(x, np.int64) for x in seqs["cint"]])
                    self.seqs.append(ids.astype(np.int32))
        self.batch_size = batch_size
        max_len = max((len(s) for s in self.seqs), default=2)
        self.cap = cap or _round_up(max_len, TOKEN_QUANTUM)
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.seqs)

    def epoch(self):
        """Shuffled fixed-shape batches; the final partial batch is padded to
        the full batch size with `valid=0` rows (the reference's padded_batch
        keeps the remainder, lm_dataset.py:38 — fixed shapes here demand
        padding instead of a ragged tail batch).

        Returns dicts {"char": [B, cap] int32, "char_len": [B] int32,
        "valid": [B] float32} with char_len counting shifted targets (len-1).
        """
        order = np.arange(len(self.seqs))
        self._rng.shuffle(order)
        B = self.batch_size
        for start in range(0, len(order), B):
            chunk = order[start:start + B]
            batch_ids = np.zeros((B, self.cap), np.int32)
            lens = np.ones((B,), np.int32)
            valid = np.zeros((B,), np.float32)
            for i, idx in enumerate(chunk):
                seq = self.seqs[idx][: self.cap]
                batch_ids[i, : len(seq)] = seq
                lens[i] = max(len(seq) - 1, 1)
                valid[i] = 1.0
            yield {"char": batch_ids, "char_len": lens, "valid": valid}
