"""Speech dataset: TFRecord SequenceExamples -> fixed-shape bucketed batches
(a copy of e2e_asr_tpu/data/speech.py without its native reader).

- every batch from a bucket is padded to the bucket's *cap* (rounded up to
  a shape quantum), so each bucket has one batch shape;
- training shuffles with a seeded RNG per epoch (full in-memory shuffles).
  The JAX package's multi-host file sharding is not ported (ROADMAP.md
  Queue 1, 'Parallelism last').

Length convention: `char`/`phone` sequences are stored as
[<go>, tokens..., <eos>] and `*_len` counts the shifted targets
(len(sequence) - 1), which is what the loss normalizes by.

The JAX package reads files through its native C++ reader (runtime/) when
it is built; the port parses them with the pure-Python codec
(data/example.py), which gives the same utterances.
"""
from __future__ import annotations

import threading
import queue as queue_mod
from dataclasses import dataclass

import numpy as np

from e2e_asr_tpu_torch.data import example as pb
from e2e_asr_tpu_torch.data import tfrecord

TIME_QUANTUM = 32     # frame-axis padding quantum
TOKEN_QUANTUM = 8     # token-axis padding quantum


@dataclass
class Utterance:
    utt_id: str
    logmel: np.ndarray          # [T, F] float32
    char: np.ndarray            # [Lc] int32, <go>...<eos>
    phone: np.ndarray           # [Lp] int32 (may be empty)


def parse_utterance(record: bytes, feat_length: int) -> Utterance:
    """Decode one SequenceExample of the corpus schema
    (speech_dataset.py:13-45 of the original recipe)."""
    context, seqs = pb.decode_sequence_example(record)
    frames = seqs.get("logmel", [])
    logmel = (np.stack(frames).astype(np.float32) if frames
              else np.zeros((0, feat_length), np.float32))
    if logmel.ndim == 1:
        logmel = logmel.reshape(-1, feat_length)
    char = np.concatenate([np.asarray(x, np.int64) for x in seqs.get("cint", [])]
                          ) if seqs.get("cint") else np.zeros(0, np.int64)
    phone = np.concatenate([np.asarray(x, np.int64) for x in seqs.get("pint", [])]
                           ) if seqs.get("pint") else np.zeros(0, np.int64)
    utt_id = context.get("segment", b"")
    return Utterance(
        utt_id=utt_id.decode() if isinstance(utt_id, bytes) else str(utt_id),
        logmel=logmel, char=char.astype(np.int32), phone=phone.astype(np.int32))


def load_files(files: list[str], feat_length: int) -> list[Utterance]:
    """Load the utterances of `files` with the pure-Python codec."""
    return [parse_utterance(rec, feat_length) for path in sorted(files)
            for rec in tfrecord.read_records(path)]


def _round_up(x: int, quantum: int) -> int:
    return max(quantum, -(-x // quantum) * quantum)


@dataclass
class BatchShape:
    frames: int
    char: int
    phone: int


def compute_bucket_shape(utts: list[Utterance]) -> BatchShape:
    max_frames = max((u.logmel.shape[0] for u in utts), default=1)
    max_char = max((len(u.char) for u in utts), default=2)
    max_phone = max((len(u.phone) for u in utts), default=2)
    return BatchShape(frames=_round_up(max_frames, TIME_QUANTUM),
                      char=_round_up(max_char, TOKEN_QUANTUM),
                      phone=_round_up(max_phone, TOKEN_QUANTUM))


def make_batch(utts: list[Utterance], shape: BatchShape, feat_length: int,
               batch_size: int, *, tasks=("char",)) -> dict:
    """Pad a list of utterances to the bucket shape. Short final batches are
    padded with zero-length dummy rows; `valid` marks real rows."""
    B = batch_size
    n = len(utts)
    batch = {
        "logmel": np.zeros((B, shape.frames, feat_length), np.float32),
        "logmel_len": np.zeros((B,), np.int32),
        "valid": np.zeros((B,), np.bool_),
        "utt_ids": [""] * B,
    }
    for task in tasks:
        cap = getattr(shape, task)
        batch[task] = np.zeros((B, cap), np.int32)
        batch[f"{task}_len"] = np.zeros((B,), np.int32)
    for i, u in enumerate(utts[:B]):
        T = min(u.logmel.shape[0], shape.frames)
        batch["logmel"][i, :T] = u.logmel[:T]
        batch["logmel_len"][i] = T
        batch["valid"][i] = True
        batch["utt_ids"][i] = u.utt_id
        for task in tasks:
            seq = getattr(u, task)
            cap = getattr(shape, task)
            L = min(len(seq), cap)
            batch[task][i, :L] = seq[:L]
            batch[f"{task}_len"][i] = max(L - 1, 0)
    # Dummy rows get length 1 to keep the length-normalized loss well-defined
    # (they contribute 0 error and are excluded by `valid` in scoring).
    for i in range(n, B):
        batch["logmel_len"][i] = 1
        for task in tasks:
            batch[f"{task}_len"][i] = 1
    return batch


class SpeechDataset:
    """One bucket's dataset: in-memory utterances + fixed-shape batching."""

    def __init__(self, files: list[str], batch_size: int, feat_length: int,
                 *, is_training: bool, tasks=("char",), seed: int = 10,
                 shape: BatchShape | None = None):
        self.utts = load_files(files, feat_length)
        self.batch_size = batch_size
        self.feat_length = feat_length
        self.is_training = is_training
        self.tasks = tuple(tasks)
        self.shape = shape or compute_bucket_shape(self.utts)
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.utts)

    def epoch(self):
        """Yield batches for one epoch. Training: reshuffled, drop-remainder
        (the fixed per-bucket batch of the original recipe's
        train.py:108-119); eval: in-order with a padded final batch."""
        order = np.arange(len(self.utts))
        if self.is_training:
            self._rng.shuffle(order)
            n_full = len(order) // self.batch_size
            order = order[: n_full * self.batch_size]
        for start in range(0, len(order), self.batch_size):
            chunk = [self.utts[i] for i in order[start:start + self.batch_size]]
            if not chunk:
                return
            yield make_batch(chunk, self.shape, self.feat_length,
                             self.batch_size, tasks=self.tasks)


def prefetch(iterator, size: int = 2):
    """Run `iterator` in a background thread with a bounded queue — the
    host-side analogue of tf.data prefetching (double buffering)."""
    q: queue_mod.Queue = queue_mod.Queue(maxsize=size)
    _END = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        yield item
