"""Dynamic-batching serving engine (port of e2e_asr_tpu/eval/serving.py):
many concurrent transcription requests, batched onto one device. The
attention family decodes by beam search (eval/beam_eval.make_beam_decoder;
a hybrid checkpoint by one-pass joint CTC/attention beams where
beam_cfg.joint_ctc > 0); the CTC family by best path at beam size 1 and
by its prefix beam search above (eval/ctc_beam.make_decoder); the
transducer family greedily at beam size 1 and by its beam search above
(eval/transducer_beam.make_decoder).

- **Static shapes**: requests are grouped into fixed frame-length buckets
  and padded to a fixed batch size, so every launch of a bucket has the
  same shapes.
- **Batching**: a background worker drains the queue, packing up to
  `max_batch` same-bucket requests per launch; under light load it waits at
  most `max_wait_ms` (from the OLDEST queued request) before launching a
  partial, padded batch.
- **Row independence**: the batched beam search treats rows independently
  and the encoder masks by length, so padding rows and shorter utterances
  sharing a bucket cannot change a request's transcript.

Feed float32 log-mel features [T, feat]; results come back as futures
resolving to transcript strings. Not ported yet (NotImplementedError, see
ROADMAP.md): a device mesh, quantized parameters, biasing glossaries and
per-request hotwords, LM fusion and confidence scores.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from e2e_asr_tpu_torch.core.checkpoint import to_device
from e2e_asr_tpu_torch.core.device import resolve
from e2e_asr_tpu_torch.eval import ctc_beam, transducer_beam
from e2e_asr_tpu_torch.eval.beam_eval import make_beam_decoder
from e2e_asr_tpu_torch.config import BeamConfig, Seq2SeqConfig
from e2e_asr_tpu_torch.data.text import get_relevant_words, ids_to_sentence


@dataclass
class ServingStats:
    requests: int = 0
    batches: int = 0
    rows_decoded: int = 0          # includes padding rows
    occupancy_sum: float = 0.0     # real rows / batch rows, summed

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / self.batches if self.batches else 0.0


@dataclass
class _Request:
    feats: np.ndarray              # [T, feat] float32
    t: float = field(default_factory=time.monotonic)   # enqueue time
    future: Future = field(default_factory=Future)


class BatchingTranscriber:
    """Queue -> bucket -> pad -> batched beam decode -> transcripts."""

    def __init__(self, params: dict, cfg: Seq2SeqConfig,
                 rev_vocab: list[str], *, device=None,
                 beam_cfg: BeamConfig | None = None,
                 bucket_frames: tuple[int, ...] = (128, 256, 512),
                 max_batch: int = 8, max_wait_ms: float = 20.0,
                 compute_dtype=None, mesh=None, lm_params=None, bias=None,
                 with_confidence: bool = False,
                 per_request_bias: float = 0.0):
        """params: the port's parameter dict (train/step.init_params'
        layout of cfg's family); it is moved to `device` (a no-op when it
        is already there; default: the CUDA card, and raises without
        one)."""
        todo = "is not ported yet (ROADMAP.md Queue 1, '{}')"
        if mesh is not None:
            raise NotImplementedError("mesh serving " + todo.format(
                "Parallelism last"))
        if not isinstance(params, dict):
            raise NotImplementedError("quantized params " + todo.format(
                "Decode features"))
        if bias is not None or per_request_bias > 0:
            raise NotImplementedError("biasing " + todo.format(
                "Decode features"))
        if with_confidence:
            raise NotImplementedError("confidence scores " + todo.format(
                "Decode features"))
        self.device = resolve(device)
        self.params = to_device(params, self.device)
        self.cfg = cfg
        self.rev_vocab = rev_vocab
        self.bucket_frames = tuple(sorted(bucket_frames))
        self.max_batch = int(max_batch)
        self.max_wait_s = max_wait_ms / 1e3
        self.stats = ServingStats()
        bc = beam_cfg or BeamConfig(beam_size=4,
                                    max_steps=cfg.max_output["char"])
        make = {"ctc": ctc_beam.make_decoder,
                "transducer": transducer_beam.make_decoder}.get(
                    cfg.model_family, make_beam_decoder)
        self._decode = make(cfg, bc, compute_dtype=compute_dtype,
                            lm_params=lm_params)
        self._queues: dict[int, list[_Request]] = {
            b: [] for b in self.bucket_frames}
        self._cv = threading.Condition()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- client API --------------------------------------------------------

    def submit(self, feats: np.ndarray) -> Future:
        """Non-blocking: returns a Future resolving to the transcript."""
        feats = np.asarray(feats, np.float32)
        if feats.ndim != 2 or feats.shape[1] != self.cfg.feat_length:
            raise ValueError(f"feats must be [T, {self.cfg.feat_length}], "
                             f"got {feats.shape}")
        if feats.shape[0] > self.bucket_frames[-1]:
            raise ValueError(
                f"utterance of {feats.shape[0]} frames exceeds the largest "
                f"bucket ({self.bucket_frames[-1]})")
        req = _Request(feats=feats)
        bucket = next(b for b in self.bucket_frames if feats.shape[0] <= b)
        with self._cv:
            if self._closed:
                raise RuntimeError("transcriber is closed")
            self._queues[bucket].append(req)
            self.stats.requests += 1
            self._cv.notify()
        return req.future

    def transcribe(self, feats: np.ndarray) -> str:
        """Blocking convenience wrapper."""
        return self.submit(feats).result()

    def close(self) -> None:
        """Drain remaining requests, then stop the worker."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify()
        self._worker.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker ------------------------------------------------------------

    def _take_batch(self) -> tuple[int, list[_Request]] | None:
        """Called under the lock: pick the next batch, or None when done.

        A full bucket launches immediately (fullest first). Otherwise the
        wait deadline tracks the OLDEST request across ALL buckets, so no
        bucket can be starved by traffic in another. Closing drains
        everything immediately.
        """
        while True:
            nonempty = [(b, q) for b, q in self._queues.items() if q]
            if not nonempty:
                if self._closed:
                    return None
                self._cv.wait()
                continue
            full = [bq for bq in nonempty if len(bq[1]) >= self.max_batch]
            pick = max(full, key=lambda bq: len(bq[1]), default=None)
            if pick is None:
                if self._closed:
                    pick = max(nonempty, key=lambda bq: len(bq[1]))
                else:
                    b, q = min(nonempty, key=lambda bq: bq[1][0].t)
                    now = time.monotonic()
                    if now < q[0].t + self.max_wait_s:
                        self._cv.wait(
                            timeout=q[0].t + self.max_wait_s - now)
                        continue
                    pick = (b, q)
            b, q = pick
            take, self._queues[b] = q[:self.max_batch], q[self.max_batch:]
            return b, take

    def _run(self) -> None:
        while True:
            with self._cv:
                picked = self._take_batch()
            if picked is None:
                return
            bucket, reqs = picked
            try:
                self._decode_batch(bucket, reqs)
            except Exception as e:  # propagate to the callers' futures
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(e)

    def _decode_batch(self, bucket: int, reqs: list[_Request]) -> None:
        B = self.max_batch                      # static batch
        feats = np.zeros((B, bucket, self.cfg.feat_length), np.float32)
        lens = np.ones((B,), np.int64)          # padding rows: 1 frame
        for i, r in enumerate(reqs):
            feats[i, :r.feats.shape[0]] = r.feats
            lens[i] = r.feats.shape[0]
        tokens, _, _ = self._decode(self.params, {"logmel": feats,
                                                  "logmel_len": lens})
        tokens = tokens.cpu().numpy()
        self.stats.batches += 1
        self.stats.rows_decoded += B
        self.stats.occupancy_sum += len(reqs) / B
        for i, r in enumerate(reqs):
            sent = ids_to_sentence(tokens[i], self.rev_vocab)
            _, words = get_relevant_words(sent)
            r.future.set_result(" ".join(words))

