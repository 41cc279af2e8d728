"""Synthetic corpus generation in the corpus's TFRecord schema (a copy of
e2e_asr_tpu/data/synth.py: the same seeds give the same bytes).

Used by tests and benchmarks: generates utterances whose log-mel features are
a deterministic (noisy) function of the target token sequence, so a correct
model can actually learn the mapping (the overfit-N-utterances e2e test).
Also writes vocab files in the recipe's layout (one token per line,
<pad>/<go>/<eos> first).
"""
from __future__ import annotations

import os

import numpy as np

from e2e_asr_tpu_torch.data import example as pb
from e2e_asr_tpu_torch.data import tfrecord
from e2e_asr_tpu_torch.data.text import EOS_ID, GO_ID, START_VOCAB, write_vocabulary

CHAR_TOKENS = list("▁abcdefghijklmnopqrstuvwxyz'&-!@#") + ["<sp>"]
PHONE_TOKENS = ["▁"] + [f"p{i}" for i in range(42)]


def make_vocab_dir(vocab_dir: str) -> dict[str, int]:
    write_vocabulary(os.path.join(vocab_dir, "char.vocab"),
                     START_VOCAB + CHAR_TOKENS)
    write_vocabulary(os.path.join(vocab_dir, "phone.vocab"),
                     START_VOCAB + PHONE_TOKENS)
    return {"char": len(START_VOCAB) + len(CHAR_TOKENS),
            "phone": len(START_VOCAB) + len(PHONE_TOKENS)}


def synth_utterance(rng: np.random.Generator, *, feat_length: int = 80,
                    char_vocab: int = 36, phone_vocab: int = 45,
                    min_tokens: int = 4, max_tokens: int = 12,
                    frames_per_token: int = 8, noise: float = 0.05):
    """Features = per-token embedding patterns repeated over frames + noise."""
    n_tok = int(rng.integers(min_tokens, max_tokens + 1))
    tokens = rng.integers(3, char_vocab, size=n_tok)
    # Deterministic token->feature pattern (fixed basis seeded globally).
    basis = np.random.default_rng(1234).normal(
        size=(char_vocab, feat_length)).astype(np.float32)
    frames = np.repeat(basis[tokens], frames_per_token, axis=0)
    frames = frames + rng.normal(scale=noise, size=frames.shape).astype(np.float32)
    char = np.concatenate([[GO_ID], tokens, [EOS_ID]]).astype(np.int64)
    # Phones: a coarse re-mapping of chars into the phone vocab.
    phone = np.concatenate(
        [[GO_ID], 3 + (tokens % (phone_vocab - 3)), [EOS_ID]]).astype(np.int64)
    return frames, char, phone


def encode_utterance(utt_id: str, frames: np.ndarray, char: np.ndarray,
                     phone: np.ndarray) -> bytes:
    context = {
        "segment": pb.encode_bytes_feature(utt_id.encode()),
        "logmel_len": pb.encode_int64_feature([frames.shape[0]]),
        "cint_len": pb.encode_int64_feature([len(char) - 1]),
        "pint_len": pb.encode_int64_feature([len(phone) - 1]),
    }
    feature_lists = {
        "logmel": [pb.encode_float_feature(f) for f in frames],
        "cint": [pb.encode_int64_feature([c]) for c in char],
        "pint": [pb.encode_int64_feature([p]) for p in phone],
    }
    return pb.encode_sequence_example(context, feature_lists)


def write_speech_corpus(path: str, n_utts: int, *, seed: int = 0,
                        feat_length: int = 80, **synth_kwargs) -> list[bytes]:
    rng = np.random.default_rng(seed)
    records = []
    for i in range(n_utts):
        frames, char, phone = synth_utterance(rng, feat_length=feat_length,
                                              **synth_kwargs)
        records.append(encode_utterance(f"utt_{seed}_{i:05d}", frames, char,
                                        phone))
    tfrecord.write_records(path, iter(records))
    return records


def write_lm_corpus(path: str, n_seqs: int, *, seed: int = 0,
                    char_vocab: int = 36, min_tokens: int = 4,
                    max_tokens: int = 16) -> None:
    rng = np.random.default_rng(seed)
    records = []
    for i in range(n_seqs):
        n_tok = int(rng.integers(min_tokens, max_tokens + 1))
        ids = np.concatenate([[GO_ID], rng.integers(3, char_vocab, size=n_tok),
                              [EOS_ID]]).astype(np.int64)
        context = {"cint_len": pb.encode_int64_feature([len(ids) - 1])}
        feature_lists = {"cint": [pb.encode_int64_feature([c]) for c in ids]}
        records.append(pb.encode_sequence_example(context, feature_lists))
    tfrecord.write_records(path, iter(records))
