#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (e2e_asr_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases; any failure exits nonzero and prints no result line:
1. device: requires CUDA; prints the card's name and power limit
   (nvidia-smi) and the torch / CUDA versions;
2. build: compiles the kernels from csrc/ with nvcc and prints ptxas's
   register / shared-memory / spill lines;
3. kernels: every kernel against its plain PyTorch version on the same
   CUDA inputs, with the error, the stated tolerance, CUDA-event times of
   both, the bound (the least time the card could take: bytes at 3.35 TB/s
   or float32 operations at 67 TFLOP/s, whichever is larger) and, where one
   PyTorch call computes the same function, that call's time:
   - serving kernels A, B, C, D at the serving shapes;
   - training kernels at the train shapes: A's training form and its
     backward (both directions, and one direction with a carry mask) on
     encoder layer 1 (T=384, B=128, H=256; beside cuDNN's nn.LSTM), the
     decoder's training forward and backward (B=128, 47 steps, 48 encoder
     frames, scheduled sampling and dropout on);
   - the LM task's kernels at its shape (B=128, T=120 input steps, lengths
     24-120, H=256): kernel #3 in its inference, masked and training forms
     and its backward #5, beside cuDNN's unidirectional nn.LSTM;
   - kernel #15, the whole beam search in one launch, on the flagship
     encoder's output for 512-frame utterances (64 frames), 120 steps:
     B=1 k=4, B=2 k=4 with unequal lengths, B=1 k=16, B=2 k=1 and an
     <eos>-rigged case; outputs equal, or parting only at a near-tie of
     the traced selections (< 1e-3); its time beside the plain version's
     and the per-step route's on the same input;
   - the GRU family's kernels on the `-gru` flagship (GRU encoder and
     decoders of the same widths): #6 (both directions in one launch,
     one direction with the carry mask, the training form) and #7 (both
     directions, one direction with the mask) on encoder layer 1 at the
     serving shape (T=512, B=8) and the train shape (T=384, B=128), beside
     cuDNN's nn.GRU (another function, a cost comparison only); #10's
     forward and backward at the step's shapes (B=128, 47 steps; the char
     decoder, V=40, on 48 encoder frames, the phone decoder, V=46, on 96);
   - the GRU decode's kernels: #11's GRU branch at N=32 (B=8, k=4) on the
     `-gru` flagship's decoder, and with two layers and SimpleProjection;
     #13 (the attention folded into C) at B=8, k=4, T=64 with an LSTM (c)
     and a GRU (h) query and at the greedy shape k=1, B=64, each beside
     the plain attention + C it replaces; #15's GRU branch on the `-gru`
     flagship's encoder output as #15's cases above (B=1 k=4, B=2 k=4
     unequal, B=1 k=16, B=2 k=1, <eos>-rigged), beside the per-step
     route;
4. serving: the flagship model (4-layer pyramidal BiLSTM, H=256, feat 80;
   1-layer LSTM attention decoder, V=40; random weights from seed 0)
   serves 24 requests through BatchingTranscriber (max_batch 8, beam 4,
   buckets 128/256/512); every serving kernel's launch count must be > 0;
   one batch decoded on the card must equal the same batch decoded by the
   plain path on the CPU, up to near-ties (< 1e-3) in the step where they
   part;
5. training: (a) one asr_step of the flagship at B=16 (T=384, L=48,
   teacher forcing, dropout on with the same masks) on the card and on the
   CPU must agree: the loss, every gradient leaf and the params after the
   step; (b) three asr_steps at the bench's train shape B=128, T=384,
   L=48, every loss finite and every training kernel launched; (c) the
   step time and frames/s;
   then the LM task and the phone multitask: (a) one lm_step at B=16 on the
   card and on the CPU (same params, batch and dropout mask) must agree
   (loss, gradients, params after), and every leaf the LM does not share
   must keep its bits on the card; (b) three asr_steps of the char + phone
   model (phone decoder on encoder layer 3) at B=128, T=384, L=48 and
   three lm_steps at B=128, T=120, every loss finite, kernels #3 and #5
   launched by the LM step and #8/#9 by both decoders; (c) their step
   times, frames/s and tokens/s;
6. recipe: a synthetic corpus at the flagship shape (384 training and 64
   dev utterances of 24-47 tokens, 8 frames a token, char and phone
   labels; 256 LM sequences of up to 120 characters) trained by the
   port's Trainer at the flagship widths (char + phone, lm_prob 0.5, one
   bucket of 128, two epochs, a checkpoint cadence every 3 ASR steps: dev
   greedy WER, LR policy, saves); a second Trainer on the same directory
   must resume the saved step's state. Fails on a non-finite loss, a
   missing checkpoint, a failed resume or a kernel of the path not
   launched;
7. entry points, at the flagship widths on a synthetic corpus (64
   training, 8 dev and 8 test utterances): `cli.main` trains 2 steps;
   `-dev -beam_size 4 -buck_batch_sizes 1` (one #15 launch per utterance,
   no per-step kernel); `-dev` greedy; `-test -beam_size 4` at a batch of
   64 (the per-step route); the same three with `-gru` (its own run
   directory; #6, #7, #10, #11's GRU branch); `tools.beam_grid.grid_search`
   over beam sizes 4 and 16 at a batch of 1; BatchingTranscriber
   (max_batch=1) serving 8 requests one at a time (p50/p90 latency). Each
   run is held to its route's launches and its output files;
8. the GRU family (`-gru`): one char + phone asr_step at B=16 on the card
   and on the CPU must agree (loss, gradients, params after), then three
   steps at B=128, T=384, L=48, every loss finite, kernels #6, #7 and #10
   launched; their step time and frames/s, and one step's device-busy
   share and per-kernel split (tools/prof_port.py); then the `-gru`
   Trainer on phase 6's corpus without the LM task (train, greedy dev WER
   through #11's GRU branch, save, exact resume), BeamEvaluator over its
   64 dev utterances at a batch of 1 (one #15 GRU launch each) and of 64
   (the per-step route: #11 GRU, #12, #14), and phase 4's serving burst
   and card-vs-CPU decode with the `-gru` model;
9. a GRU encoder under the LSTM decoders: the Trainer on phase 6's corpus
   (train, greedy dev WER, save, resume), BeamEvaluator over its 64 dev
   utterances at a batch of 1 (one #15 launch each), and phase 4's
   serving burst and card-vs-CPU decode; each run launches #6;
10. kernel #13 on the route: with E2E_ASR_FUSED_ATTN set and then
   restored, a greedy and a per-step beam decode (beam 4) of 64 utterances
   by the flagship and by the `-gru` flagship launch #13 and not C, and
   equal the same decodes without it up to near-ties (< 1e-3); both
   routes' times side by side.
Each main-path run (serving, ASR training, LM + multitask, recipe, each
entry-point run, the GRU runs, the #13 runs) counts its kernels' launches
from zero; a row's `launches` in the kernels line is their sum over those
runs. The line before the last is a JSON object with the per-kernel
numbers; the last line is {"ok": true, "device": {...}}. float32
throughout, TF32 off. No phase runs at a cut depth: the run took 87 s on
the card before the GRU decode and #13 joined it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from e2e_asr_tpu_torch.config import (BeamConfig, DecoderConfig,
                                      EncoderConfig, ExperimentConfig,
                                      LMConfig, Seq2SeqConfig, TrainConfig)
from e2e_asr_tpu_torch.core import cells, checkpoint
from e2e_asr_tpu_torch.core.checkpoint import named_from_params, to_device
from e2e_asr_tpu_torch.core.layers import dropout_mask
from e2e_asr_tpu_torch.data import synth
from e2e_asr_tpu_torch.cli import main as cli
from e2e_asr_tpu_torch.data import text
from e2e_asr_tpu_torch.data.text import EOS_ID, GO_ID, START_VOCAB
from e2e_asr_tpu_torch.data.speech import SpeechDataset
from e2e_asr_tpu_torch.eval import beam, beam_eval
from e2e_asr_tpu_torch.eval.serving import BatchingTranscriber
from e2e_asr_tpu_torch.kernels import (attn_output, beam_mega, beam_select,
                                       build, dec_step, dec_train,
                                       dec_train_gru, gru_seq, lstm_bidir,
                                       lstm_seq)
from e2e_asr_tpu_torch.models import attn_decoder, encoder, seq2seq
from e2e_asr_tpu_torch.tools import beam_grid
from e2e_asr_tpu_torch.train import step
from e2e_asr_tpu_torch.train.loop import Trainer

# Tolerances against the plain version on the card: forward values of order
# 1 take 1e-4 absolute (float32 sums in another order); gradients, whose
# sums run over up to T*B = 49152 rows, 1e-4 relative to each output's
# largest value; the selection is exact.
TOL = {"lstm_bidir": 1e-4, "cells_fused": 1e-4, "output_fused": 1e-4,
       "beam_select": 0.0, "lstm_bidir_train": 1e-4, "lstm_bidir_bwd": 1e-4,
       "lstm_bwd": 1e-4, "dec_train_fwd": 1e-4, "dec_train_bwd": 1e-4,
       "lstm_seq": 1e-4, "lstm_seq_masked": 1e-4, "lstm_seq_train": 1e-4,
       "lstm_bwd_lm": 1e-4, "gru_bidir": 1e-4, "gru_seq_masked": 1e-4,
       "gru_bidir_train": 1e-4, "gru_bidir_bwd": 1e-4, "gru_bwd": 1e-4,
       "dec_train_gru_fwd": 1e-4, "dec_train_gru_bwd": 1e-4,
       "dec_train_gru_fwd_phone": 1e-4, "dec_train_gru_bwd_phone": 1e-4,
       "cells_fused_gru": 1e-4, "attn_output_fused": 1e-4}
RELATIVE = {"lstm_bidir_bwd", "lstm_bwd", "dec_train_bwd", "lstm_bwd_lm",
            "gru_bidir_bwd", "gru_bwd", "dec_train_gru_bwd",
            "dec_train_gru_bwd_phone"}
NEAR_TIE = 1e-3
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12   # H100 SXM: f32 (no tensor cores)
TRAIN_B, TRAIN_T, TRAIN_L = 128, 384, 48  # the bench's train shape
LM_B, LM_T = 128, 120     # lm_batch_size; input steps (the char max_output)
PHONE_VOCAB = 46          # data/synth.py's phone vocabulary
MEGA_T, MEGA_S = 64, 120  # encoder frames of a 512-frame bucket; max_steps
# Kernel #15's scores where it and its plain version select the same
# hypotheses: sums of up to 120 float32 log-probs, 1e-5 of |score| (at
# least 1e-4).
MEGA_SCORE_TOL = 1e-5


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, n: int, warmup: int = 2) -> float:
    """Mean time of fn() over n calls, by CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def max_err(got, want) -> tuple[float, float]:
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel = max(float(((g - w).abs() / w.abs().clamp_min(1e-6)).max())
              for g, w in zip(got, want))
    return abs_err, rel


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(flops: float, moved: int) -> tuple[float, str]:
    """(least ms on the card, what bounds it): float32 operations at the
    peak rate or bytes at the memory rate, whichever takes longer."""
    ops_ms, bytes_ms = flops / PEAK_FLOPS * 1e3, moved / PEAK_BYTES * 1e3
    return ((ops_ms, "operations") if ops_ms >= bytes_ms
            else (bytes_ms, "bytes"))


def flagship_cfg(char_vocab: int = 40, phone_vocab: int | None = None,
                 cells: str = "lstm"):
    """The flagship model; with phone_vocab, the recipe's char + phone
    multitask (a phone decoder of the same widths on encoder layer 3, the
    `-nlp` default). cells: "lstm"; "gru", the GRU family of `-gru` (GRU
    encoder and decoders); "gru_encoder", a GRU encoder under the LSTM
    decoders."""
    def dec(vocab, max_output):
        return DecoderConfig(hidden_size_dec=256, emb_size=256,
                             vocab_size=vocab, lm_hidden_size=256,
                             attention_vec_size=128, max_output=max_output,
                             use_lstm=cells != "gru")

    tasks, layers, out = ["char"], {"char": 4}, {"char": 120}
    decoders = {"char": dec(char_vocab, 120)}
    if phone_vocab is not None:
        tasks.append("phone")
        layers["phone"], out["phone"] = 3, 250
        decoders["phone"] = dec(phone_vocab, 250)
    return Seq2SeqConfig(
        tasks=tasks, num_layers=layers, max_output=out,
        encoder=EncoderConfig(hidden_size=256, skip_step=2,
                              max_scaling_down=8, use_lstm=cells == "lstm"),
        decoders=decoders, avg=True, feat_length=80)


class Recorder:
    """Holds each kernel to its plain version and keeps its JSON row."""

    def __init__(self):
        self.rows = []

    def __call__(self, name, source, replaces, got, want, fn, ref, n, n_ref,
                 work, library=None, **extra):
        abs_err, rel_err, kind = self.hold(name, got, want)
        self.add(name, source, replaces, abs_err,
                 f"max_rel_err={rel_err:.3e} tolerance={TOL[name]:.0e} "
                 f"({kind})", time_ms(fn, n), time_ms(ref, n_ref, warmup=1),
                 work, None if library is None else library(), **extra)

    @staticmethod
    def hold(name, got, want) -> tuple[float, float, str]:
        """(absolute error, relative error, kind) of a kernel's outputs
        against its plain version's; fails past the row's tolerance."""
        if name in RELATIVE:
            errs = [(float((g - w).abs().max()),
                     max(float(w.abs().max()), 1e-6))
                    for g, w in zip(got, want)]
            abs_err = max(e for e, _ in errs)
            rel_err = max(e / s for e, s in errs)
            ok = rel_err <= TOL[name]
        else:
            abs_err, rel_err = max_err(got, want)
            ok = abs_err <= TOL[name]
        if not ok:
            fail(f"{name} disagrees with its plain version: {abs_err} "
                 f"(relative {rel_err})")
        return abs_err, rel_err, "relative" if name in RELATIVE else "absolute"

    def add(self, name, source, replaces, abs_err, note, ms, plain_ms, work,
            library_ms, **extra):
        """Print and keep a row whose error has been checked."""
        bound_ms, bound_by = bound(*work)
        lib = "none" if library_ms is None else f"{library_ms:.4f}"
        print(f"kernel {name}: max_abs_err={abs_err:.3e} {note} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bound_ms:.4f} ({bound_by}) library_ms={lib}"
              + "".join(f" {k}={v:.4f}" for k, v in extra.items()),
              flush=True)
        self.rows.append({"name": name, "route": "cuda", "source": source,
                          "replaces": replaces, "max_abs_err": abs_err,
                          "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": library_ms, **extra})


def cudnn_lstm_ms(x, lens, H, bidirectional, backward,
                  rnn=torch.nn.LSTM) -> float:
    """cuDNN's nn.LSTM (or `rnn`) on the packed batch (same input width,
    hidden size and lengths): its training forward, or its backward as the
    time of forward + backward less the forward's. Timed only, as a
    yardstick."""
    lstm = rnn(x.shape[-1], H, bidirectional=bidirectional).to(x.device)
    xg = x.detach().clone().requires_grad_(True)
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        xg, lens.cpu(), enforce_sorted=False)
    fwd_ms = time_ms(lambda: lstm(packed), 5)
    if not backward:
        return fwd_ms
    leaves = [xg, *lstm.parameters()]
    g = torch.randn_like(lstm(packed)[0].data)

    def fwd_bwd():   # the packing's graph is kept for the next call
        torch.autograd.grad(lstm(packed)[0].data, leaves, g,
                            retain_graph=True)

    return time_ms(fwd_bwd, 5) - fwd_ms


def check_kernels(params, cfg, dev, record: Recorder) -> None:
    """Phase 3, serving kernels at the serving shapes (A: T=512, B=8,
    H=256; B, C: N=32 rows; D: B=8, k=4, V=40)."""
    rng = np.random.default_rng(1)
    rand = lambda *s, scale=1.0: torch.tensor(  # noqa: E731
        rng.normal(size=s).astype(np.float32) * scale, device=dev)
    dec = params["decoder_char"]
    dcfg = cfg.decoders["char"]

    # A: encoder layer 1 of the flagship on random log-mel features.
    T, B, H = 512, 8, cfg.encoder.hidden_size
    layer = params["encoder"]["layer_1"]
    x = rand(T, B, cfg.feat_length)
    lens = torch.tensor(rng.integers(40, T + 1, size=B), device=dev)
    lens[0] = T
    xf = cells.lstm_precompute_inputs(layer["fw"], x, cfg.feat_length)
    xb = cells.lstm_precompute_inputs(layer["bw"], torch.flip(x, [0]),
                                      cfg.feat_length)
    mask = (torch.arange(T, device=dev)[:, None]
            >= T - lens[None, :]).float()[:, :, None]
    a_args = (xf, xb, layer["fw"]["kernel"][cfg.feat_length:],
              layer["bw"]["kernel"][cfg.feat_length:], mask)
    got = lstm_bidir.lstm_seq_bidir(*a_args)
    record("lstm_bidir", "e2e_asr_tpu_torch/csrc/lstm_bidir.cu",
           "e2e_asr_tpu/ops/lstm_pallas.py:625", got,
           lstm_bidir.lstm_seq_bidir_reference(*a_args),
           lambda: lstm_bidir.lstm_seq_bidir(*a_args),
           lambda: lstm_bidir.lstm_seq_bidir_reference(*a_args), 20, 2,
           (2 * T * B * 2 * H * 4 * H, nbytes(*a_args, *got)),
           lambda: cudnn_lstm_ms(x, lens, H, True, False))

    # B and C: one decode step over N = 8 rows x 4 beams.
    N, Hd, Henc = 32, dcfg.hidden_size_dec, 2 * cfg.encoder.hidden_size
    tokens = torch.tensor(rng.integers(0, dcfg.vocab_size, size=N),
                          device=dev)
    state = lambda w: cells.LSTMState(rand(N, w, scale=0.5),  # noqa: E731
                                      rand(N, w, scale=0.5))
    b_args = (dec, dec["embedding"][tokens], rand(N, Henc, scale=0.3),
              state(dcfg.lm_hidden_size),
              tuple(state(Hd) for _ in range(dcfg.num_layers_dec)))
    flat = lambda out: [out[0].c, out[0].h, out[2]] + [  # noqa: E731
        t for s in out[1] for t in s]
    b_weights = [dec[k][p] for k in ("lm_cell", "input_proj", "attn_query")
                 for p in ("kernel", "bias")] + [
        t for c in dec["dec_cells"] for t in (c["kernel"], c["bias"])]
    got = flat(dec_step.cells_fused(*b_args))
    record("cells_fused", "e2e_asr_tpu_torch/csrc/dec_step.cu",
           "e2e_asr_tpu/ops/dec_step_pallas.py:208", got,
           flat(dec_step.cells_fused_reference(*b_args)),
           lambda: dec_step.cells_fused(*b_args),
           lambda: dec_step.cells_fused_reference(*b_args), 200, 50,
           (2 * N * sum(w.numel() for w in b_weights if w.dim() == 2),
            nbytes(*b_weights, *b_args[1:3], *b_args[3], *got)))
    c_args = (dec, dcfg, rand(N, Hd, scale=0.5), rand(N, Henc, scale=0.3))
    c_weights = [dec[k][p] for k in ("attn_proj", "output_proj")
                 for p in ("kernel", "bias")]
    got = [dec_step.output_fused(*c_args)]
    record("output_fused", "e2e_asr_tpu_torch/csrc/dec_step.cu",
           "e2e_asr_tpu/ops/dec_step_pallas.py:351", got,
           [dec_step.output_fused_reference(*c_args)],
           lambda: dec_step.output_fused(*c_args),
           lambda: dec_step.output_fused_reference(*c_args), 200, 50,
           (2 * N * (c_weights[0].numel() + c_weights[2].numel()),
            nbytes(*c_weights, *c_args[2:], *got)))

    # D: one selection step with dead parents and finished hypotheses.
    k, V = 4, dcfg.vocab_size
    scores = -torch.rand(B, k, device=dev) * 20
    logp = torch.log_softmax(rand(B, k, V, scale=3.0), dim=-1)
    alive = torch.tensor(rng.random((B, k)) < 0.7, device=dev)
    alive[:, 0] = True
    nf = torch.tensor(rng.integers(0, k, size=B), dtype=torch.int32,
                      device=dev)
    d_args = (scores, logp, alive, nf)
    got = beam_select.beam_select(*d_args)
    want = beam_select.beam_select_reference(*d_args)
    record("beam_select", "e2e_asr_tpu_torch/csrc/beam_select.cu",
           "e2e_asr_tpu/ops/beam_select_pallas.py:147",
           [got[key].float() for key in want],
           [want[key].float() for key in want],
           lambda: beam_select.beam_select(*d_args),
           lambda: beam_select.beam_select_reference(*d_args), 200, 50,
           (B * k * V * k, nbytes(*d_args, *got.values())))


def near_tie_partings(what: str, free, kernel_tokens, gum_sh, flag_sh
                      ) -> int:
    """Where a decoder's training kernel samples other tokens than its
    plain version run freely (`free`, its logits), each row's first
    parting must be a near-tie of the plain run's sampling scores; fails
    otherwise. Returns the number of rows that part."""
    plain_tokens = dec_train.sampled_tokens(free, gum_sh)
    differ = (kernel_tokens != plain_tokens) & (flag_sh > 0)
    for b in range(differ.shape[1]):
        steps = torch.nonzero(differ[:, b]).flatten()
        if len(steps):     # later steps of this row follow the first part
            t = int(steps[0])
            z = free[t - 1, b] + gum_sh[t, b]
            gap = float(z[plain_tokens[t, b]] - z[kernel_tokens[t, b]])
            print(f"{what} row {b}: sampled tokens part at step {t}, "
                  f"gap {gap:.3e} (near-tie limit {NEAR_TIE})")
            if gap >= NEAR_TIE:
                fail(f"{what} row {b} samples another token at step {t}: "
                     f"gap {gap}")
    parted = int(differ.any(0).sum())
    print(f"{what}: {int((flag_sh[:, 0] > 0).sum())} sampled steps, "
          f"{parted} rows part at a near-tie", flush=True)
    return parted


def check_train_kernels(params, cfg, dev, record: Recorder) -> None:
    """Phase 3, training kernels at the train shapes: A's training form and
    backward on encoder layer 1 (T=384, B=128, H=256), the decoder's
    training forward and backward (B=128, 47 steps, 48 encoder frames)."""
    rng = np.random.default_rng(3)
    rand = lambda *s, scale=1.0: torch.tensor(  # noqa: E731
        rng.normal(size=s).astype(np.float32) * scale, device=dev)
    T, B, H, F = TRAIN_T, TRAIN_B, cfg.encoder.hidden_size, cfg.feat_length
    layer = params["encoder"]["layer_1"]
    x = rand(T, B, F)
    lens = torch.tensor(rng.integers(T // 2, T + 1, size=B), device=dev)
    lens[0] = T
    with torch.no_grad():
        xf = cells.lstm_precompute_inputs(layer["fw"], x, F)
        xb = cells.lstm_precompute_inputs(layer["bw"], torch.flip(x, [0]), F)
    mask = (torch.arange(T, device=dev)[:, None]
            >= T - lens[None, :]).float()[:, :, None]
    wf, wb = layer["fw"]["kernel"][F:], layer["bw"]["kernel"][F:]
    a_args = (xf, xb, wf, wb, mask)
    fwd = lstm_bidir.lstm_seq_bidir_train(*a_args)
    lstm_ops = T * B * 2 * H * 4 * H        # one [H, 4H] product, one way
    record("lstm_bidir_train", "e2e_asr_tpu_torch/csrc/lstm_bidir.cu",
           "e2e_asr_tpu/ops/lstm_pallas.py:625", fwd,
           lstm_bidir.lstm_seq_bidir_reference(*a_args, save_c=True),
           lambda: lstm_bidir.lstm_seq_bidir_train(*a_args),
           lambda: lstm_bidir.lstm_seq_bidir_reference(*a_args, save_c=True),
           5, 1, (2 * lstm_ops, nbytes(*a_args, *fwd)),
           lambda: cudnn_lstm_ms(x, lens, H, True, False))
    h_fw, h_bw, c_fw, c_bw = fwd
    g_fw, g_bw = rand(T, B, H), rand(T, B, H)
    bw_args = (wf, wb, h_fw, c_fw, xf, g_fw, h_bw, c_bw, xb, g_bw, mask)
    got = lstm_bidir.lstm_bidir_bwd(*bw_args)

    def plain_bidir():
        return (*lstm_bidir.lstm_bwd_reference(wf, h_fw, c_fw, xf, g_fw),
                *lstm_bidir.lstm_bwd_reference(wb, h_bw, c_bw, xb, g_bw,
                                               mask))

    # Gates recompute, dh_{t-1} and dW_h: three [H, 4H] products a row-step.
    record("lstm_bidir_bwd", "e2e_asr_tpu_torch/csrc/lstm_bidir_bwd.cu",
           "e2e_asr_tpu/ops/lstm_pallas.py:1381", got, plain_bidir(),
           lambda: lstm_bidir.lstm_bidir_bwd(*bw_args), plain_bidir, 5, 1,
           (2 * 3 * lstm_ops, nbytes(*bw_args, *got)),
           lambda: cudnn_lstm_ms(x, lens, H, True, True))
    one_args = (wb, h_bw, c_bw, xb, g_bw, mask)
    got = lstm_bidir.lstm_bwd(*one_args)
    record("lstm_bwd", "e2e_asr_tpu_torch/csrc/lstm_bidir_bwd.cu",
           "e2e_asr_tpu/ops/lstm_pallas.py:975", got,
           lstm_bidir.lstm_bwd_reference(*one_args),
           lambda: lstm_bidir.lstm_bwd(*one_args),
           lambda: lstm_bidir.lstm_bwd_reference(*one_args), 5, 1,
           (3 * lstm_ops, nbytes(*one_args, *got)),
           lambda: cudnn_lstm_ms(x, lens, H, False, True))

    # The decoder's training pass on encoder-layer-4-sized states, with
    # scheduled sampling on every other step and dropout.
    dec, dcfg = params["decoder_char"], cfg.decoders["char"]
    S, Te = TRAIN_L - 1, TRAIN_T // 8
    enc = rand(B, Te, 2 * H, scale=0.5)
    enc_lens = torch.tensor(rng.integers(Te // 2, Te + 1, size=B), device=dev)
    enc_lens[0] = Te
    ids = torch.tensor(rng.integers(3, dcfg.vocab_size, size=(S + 1, B)),
                       device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    _, gumbel, lm_masks, _ = attn_decoder.train_noise(gen, dcfg, S, B, dev)
    flags = (torch.arange(S, device=dev) % 2).float()
    with torch.no_grad():
        emb_in = dec["embedding"][ids]
        tlmx = (emb_in[:S] @ dec["lm_cell"]["kernel"][:dcfg.emb_size]
                + dec["lm_cell"]["bias"])
        weights = [w.contiguous() for w in dec_train.weight_args(
            dec, dcfg.emb_size)]
        hf = enc @ dec["attn_w"]
    amask = (torch.arange(Te, device=dev)[None, :]
             < enc_lens[:, None]).float()
    gum_sh = torch.cat([gumbel.new_zeros(1, B, dcfg.vocab_size),
                        gumbel[:-1]])
    flag_sh = torch.cat([flags.new_zeros(1), flags[:-1]])[:, None].expand(
        S, B).contiguous()
    leaves = [t.detach().requires_grad_(True)
              for t in (*weights, hf, enc, tlmx)]
    d_args = (leaves[:13], *leaves[13:15], amask, leaves[15], gum_sh,
              flag_sh, lm_masks)
    logits = dec_train.dec_train(*d_args)
    kernel_tokens = dec_train.sampled_tokens(logits.detach(), gum_sh)
    with torch.no_grad():
        free = dec_train.dec_train_reference(*d_args)
    near_tie_partings("dec_train", free, kernel_tokens, gum_sh, flag_sh)

    def plain():
        return dec_train.dec_train_reference(*d_args, sampled=kernel_tokens)

    G, D, E, A, V = (dcfg.lm_hidden_size, dcfg.hidden_size_dec, 2 * H,
                     dcfg.attention_vec_size, dcfg.vocab_size)
    M = dcfg.emb_size
    products = (G * 4 * G + (G + E) * M + (M + D) * 4 * D + D * A
                + (D + E) * D + D * V)
    attn = Te * A * 3 + Te * E * 2
    inputs = nbytes(*leaves, amask, gum_sh, flag_sh, lm_masks)
    with torch.no_grad():
        record("dec_train_fwd", "e2e_asr_tpu_torch/csrc/dec_train.cu",
               "e2e_asr_tpu/ops/dec_train_pallas.py:337", [logits.detach()],
               [plain()], lambda: dec_train.dec_train(*d_args), plain, 5, 2,
               (S * B * (2 * products + attn), inputs + nbytes(logits)))
    dlog = rand(S, B, V)
    got = torch.autograd.grad(logits, leaves, dlog, retain_graph=True)
    want_out = plain()
    want = torch.autograd.grad(want_out, leaves, dlog, retain_graph=True)
    # Data gradients, then the weight gradients: twice the forward's
    # products, and about three times its attention work. It reads the
    # forward's saves: per row and step 7G + M + 7D + A + Te + E + V floats.
    saves = S * B * 4 * (7 * G + M + 7 * D + A + Te + E + V)
    record("dec_train_bwd", "e2e_asr_tpu_torch/csrc/dec_train.cu",
           "e2e_asr_tpu/ops/dec_train_pallas.py:656", got, want,
           lambda: torch.autograd.grad(logits, leaves, dlog,
                                       retain_graph=True),
           lambda: torch.autograd.grad(want_out, leaves, dlog,
                                       retain_graph=True), 5, 2,
           (S * B * (4 * products + 3 * attn),
            inputs + nbytes(dlog, *got) + saves))


def decoder_matrices(dec) -> list:
    """The 2-D weights of a decoder step (LSTM or GRU cells): every kernel
    but attn_w (applied to the encoder states once, before the steps) and
    the embedding (a gather)."""
    return [w for name, w in checkpoint.flatten_named(dec).items()
            if w.dim() == 2 and not name.startswith(("attn_w", "embedding"))]


def mega_work(dec, B: int, k: int, Henc: int, steps: int, inputs,
              outputs) -> tuple[float, int]:
    """(operations, bytes) of one whole search of kernel #15 that runs
    `steps` steps over N = B*k rows and MEGA_T encoder frames: the products
    of every 2-D decoder weight the step uses (not attn_w, applied before
    the search, nor the embedding, a gather), the attention (add, tanh,
    multiply, sum over A; the context over Henc) and the softmaxes; bytes:
    each input read once, each output written once."""
    N, A = B * k, dec["attn_query"]["kernel"].shape[-1]
    mats = decoder_matrices(dec)
    V = dec["output_proj"]["kernel"].shape[-1]
    per_step = (2 * N * sum(w.numel() for w in mats)
                + N * MEGA_T * (4 * A + 2 * Henc + 4) + 4 * N * V)
    return steps * per_step, nbytes(*inputs, *outputs)


def check_mega(params, cfg, dev, record: Recorder,
               name: str = "beam_mega") -> None:
    """Phase 3, kernel #15 (row `name`: "beam_mega" for the flagship's
    LSTM decoder, "beam_mega_gru" for the `-gru` flagship's GRU decoder)
    at the flagship widths on the model's encoder output for 512-frame
    utterances (64 frames), 120 steps: B=1 k=4, B=2 k=4 with unequal
    lengths, B=1 k=16, B=2 k=1 and an <eos>-rigged B=2 k=4 (the output
    kernel zero, the <eos> bias 50: every hypothesis finishes at its first
    step). Each case is one launch; its outputs equal the plain version's,
    or part at a near-tie. Times at B=1 k=4 beside the plain version's and
    the per-step route's."""
    dec, dcfg = params["decoder_char"], cfg.decoders["char"]
    counter = COUNTERS[name][1]
    rng = np.random.default_rng(11)
    feats = torch.tensor(rng.normal(size=(2, 8 * MEGA_T, cfg.feat_length))
                         .astype(np.float32), device=dev)
    with torch.no_grad():
        states, _, lens = seq2seq.encode(params, cfg, feats, torch.tensor(
            [8 * MEGA_T, 300], device=dev))
    depth = cfg.num_layers["char"]
    enc, enc_lens = states[depth].contiguous(), lens[depth]
    rigged = dict(dec, output_proj={
        "kernel": torch.zeros_like(dec["output_proj"]["kernel"]),
        "bias": torch.zeros_like(dec["output_proj"]["bias"])})
    rigged["output_proj"]["bias"][EOS_ID] = 50.0
    worst, parted, steps_run = 0.0, 0, {}
    for case, B, k, p in (("b1_k4", 1, 4, dec), ("b2_k4", 2, 4, dec),
                          ("b1_k16", 1, 16, dec), ("b2_k1", 2, 1, dec),
                          ("b2_k4_eos_rigged", 2, 4, rigged)):
        what = f"{name} {case}"
        bc = BeamConfig(beam_size=k, max_steps=MEGA_S)
        ctx = attn_decoder.make_attn_context(p, enc[:B], enc_lens[:B])
        args = (p, dcfg, bc, ctx.enc_states, ctx.hidden_features, ctx.mask)
        before = getattr(beam_mega, counter)
        got = beam_mega.beam_decode_mega(*args, trace=True)
        torch.cuda.synchronize()
        if getattr(beam_mega, counter) != before + 1:
            fail(f"{what}: not one launch")
        want = beam_mega.beam_decode_mega_reference(*args, trace=True)
        try:
            parts = beam_mega.parting(got, want, NEAR_TIE)
        except ValueError as e:
            fail(f"{what} disagrees with its plain version: {e}")
        tokens, out_lens, scores, trace = [
            x.cpu() if torch.is_tensor(x) else x for x in got]
        for b, part in enumerate(parts):
            if part is not None:
                parted += 1
                print(f"{what} utterance {b}: parts from the plain version "
                      f"at step {part[0]} rank {part[1]}, selection gap "
                      f"{part[2]:.3e} (near-tie limit {NEAR_TIE})")
                continue
            err = abs(float(scores[b]) - float(want[2][b]))
            if err > MEGA_SCORE_TOL * max(1.0, abs(float(want[2][b]))):
                fail(f"{what} utterance {b}: score error {err}")
            worst = max(worst, err)
        if (tokens.shape != (B, MEGA_S) or not torch.isfinite(scores).all()
                or not ((tokens >= 0) & (tokens < dcfg.vocab_size)).all()
                or not ((out_lens >= 1) & (out_lens <= MEGA_S)).all()):
            fail(f"{what}: bad outputs {out_lens.tolist()} "
                 f"{scores.tolist()}")
        if p is rigged and out_lens.tolist() != [1] * B:
            fail(f"{what}: the rigged decoder did not finish at its first "
                 f"step: {out_lens.tolist()}")
        steps_run[case] = len(trace["vals"])
        print(f"{what}: {steps_run[case]} steps in one launch, lengths "
              f"{out_lens.tolist()}, scores {scores.tolist()}", flush=True)
    bc = BeamConfig(beam_size=4, max_steps=MEGA_S)
    ctx = attn_decoder.make_attn_context(dec, enc[:1], enc_lens[:1])
    args = (dec, dcfg, bc, ctx.enc_states, ctx.hidden_features, ctx.mask)
    out = beam_mega.beam_decode_mega(*args)
    weights = [w for key, w in checkpoint.flatten_named(dec).items()
               if not key.startswith("attn_w")]
    record.add(name, "e2e_asr_tpu_torch/csrc/beam_mega.cu",
               "e2e_asr_tpu/ops/beam_megakernel.py:368", worst,
               f"score_tolerance={MEGA_SCORE_TOL:.0e} (relative) "
               f"near_tie_partings={parted} (B=1 k=4 T={MEGA_T} "
               f"{steps_run['b1_k4']} steps)",
               time_ms(lambda: beam_mega.beam_decode_mega(*args), 5),
               time_ms(lambda: beam_mega.beam_decode_mega_reference(*args), 2,
                       warmup=1),
               mega_work(dec, 1, 4, enc.shape[-1], steps_run["b1_k4"],
                         [*args[3:], *weights], out),
               None,
               steps_route_ms=time_ms(lambda: beam.beam_decode_steps(
                   dec, dcfg, bc, enc[:1], enc_lens[:1]), 2, warmup=1))
    print(f"{name}: library none (no single PyTorch call computes a beam "
          "search); steps_route_ms is the per-step route it replaces on the "
          "same input", flush=True)


def lm_batch(rng, B: int, V: int):
    """An LM batch as data/lm.py gives one, time-major: ids [LM_T + 1, B]
    from <go> with 24-LM_T tokens (the last <eos>), their counts, and the
    rows' validity."""
    lens = rng.integers(24, LM_T + 1, size=B)
    lens[0] = LM_T
    ids = np.zeros((LM_T + 1, B), np.int32)
    ids[0] = GO_ID
    for b, n in enumerate(lens):
        ids[1:n, b] = rng.integers(3, V, size=n - 1)
        ids[n, b] = EOS_ID
    return ids, lens.astype(np.int32), np.ones(B, np.float32)


def check_lm_kernels(params, cfg, dev, record: Recorder) -> None:
    """Phase 3, the LM task's kernels at its shape: #3 (inference, masked,
    training forms) and its backward #5 over the char decoder's LM cell
    (B=128, T=120, lengths 24-120, H=256), beside cuDNN's nn.LSTM."""
    rng = np.random.default_rng(7)
    rand = lambda *s: torch.tensor(  # noqa: E731
        rng.normal(size=s).astype(np.float32), device=dev)
    dec, dcfg = params["decoder_char"], cfg.decoders["char"]
    T, B, H, E = LM_T, LM_B, dcfg.lm_hidden_size, dcfg.emb_size
    ids, lens, _ = lm_batch(rng, B, dcfg.vocab_size)
    lm = dec["lm_cell"]
    with torch.no_grad():
        emb_in = dec["embedding"][torch.tensor(ids[:-1], device=dev).long()]
        xp = cells.lstm_precompute_inputs(lm, emb_in, E).contiguous()
    w = lm["kernel"][E:]
    mask = (torch.arange(T, device=dev)[:, None] < torch.tensor(
        lens, device=dev)[None, :]).float()[:, :, None]
    lens_cpu = torch.tensor(lens)
    ops = T * B * 2 * H * 4 * H            # one [H, 4H] product a row-step
    src = "e2e_asr_tpu_torch/csrc/lstm_seq.cu"
    pallas = "e2e_asr_tpu/ops/lstm_pallas.py:438"
    cudnn = lambda: cudnn_lstm_ms(emb_in, lens_cpu, H, False, False)  # noqa
    with torch.no_grad():
        for name, m in (("lstm_seq", None), ("lstm_seq_masked", mask)):
            got = [lstm_seq.lstm_seq(xp, w, m)]
            record(name, src, pallas, got,
                   [lstm_seq.lstm_seq_reference(xp, w, m)],
                   lambda m=m: lstm_seq.lstm_seq(xp, w, m),
                   lambda m=m: lstm_seq.lstm_seq_reference(xp, w, m), 20, 2,
                   (ops, nbytes(xp, w, m, *got)), cudnn)
        fwd = lstm_seq.lstm_seq_train(xp, w)
        record("lstm_seq_train", src, pallas, fwd,
               lstm_seq.lstm_seq_reference(xp, w, save_c=True),
               lambda: lstm_seq.lstm_seq_train(xp, w),
               lambda: lstm_seq.lstm_seq_reference(xp, w, save_c=True), 20,
               2, (ops, nbytes(xp, w, *fwd)), cudnn)
    h, c = fwd
    g = rand(T, B, H)
    bw_args = (w, h, c, xp, g)
    got = lstm_bidir.lstm_bwd(*bw_args)
    record("lstm_bwd_lm", "e2e_asr_tpu_torch/csrc/lstm_bidir_bwd.cu",
           "e2e_asr_tpu/ops/lstm_pallas.py:975", got,
           lstm_bidir.lstm_bwd_reference(*bw_args),
           lambda: lstm_bidir.lstm_bwd(*bw_args),
           lambda: lstm_bidir.lstm_bwd_reference(*bw_args), 10, 1,
           (3 * ops, nbytes(*bw_args, *got)),
           lambda: cudnn_lstm_ms(emb_in, lens_cpu, H, False, True))


def gru_layer_case(params, cfg, dev, rng, T: int, B: int) -> dict:
    """Kernel #6's and #7's inputs on encoder layer 1 of a GRU model at
    [T, B]: random log-mel features of lengths T/2..T (one row T), the
    input contributions of both directions (the backward one of the
    flipped sequence), the recurrent kernels, the flipped sequence's
    validity mask, the training forward's saves and output gradients."""
    F = cfg.feat_length
    layer = params["encoder"]["layer_1"]
    x = torch.tensor(rng.normal(size=(T, B, F)).astype(np.float32),
                     device=dev)
    lens = torch.tensor(rng.integers(T // 2, T + 1, size=B), device=dev)
    lens[0] = T
    with torch.no_grad():
        gx_fw, cx_fw = cells.gru_precompute_inputs(layer["fw"], x, F)
        gx_bw, cx_bw = cells.gru_precompute_inputs(layer["bw"],
                                                   torch.flip(x, [0]), F)
    w = {d: (layer[d]["gates"]["kernel"][F:],
             layer[d]["candidate"]["kernel"][F:]) for d in ("fw", "bw")}
    mask = (torch.arange(T, device=dev)[:, None]
            >= T - lens[None, :]).float()[:, :, None]
    bidir = (gx_fw, cx_fw, gx_bw, cx_bw, *w["fw"], *w["bw"], mask)
    (h_fw, ru_fw, c_fw), (h_bw, ru_bw, c_bw) = (
        gru_seq.gru_seq_reference(gx_fw, cx_fw, *w["fw"], save=True),
        gru_seq.gru_seq_reference(gx_bw, cx_bw, *w["bw"], mask, save=True))
    H = h_fw.shape[-1]
    g = [torch.tensor(rng.normal(size=(T, B, H)).astype(np.float32),
                      device=dev) for _ in range(2)]
    return {"x": x, "lens": lens, "bidir": bidir,
            "masked": (gx_bw, cx_bw, *w["bw"], mask),
            "bwd_fw": (*w["fw"], h_fw, ru_fw, c_fw, g[0], None),
            "bwd_bw": (*w["bw"], h_bw, ru_bw, c_bw, g[1], mask)}


def gru_ops(T: int, B: int, H: int) -> int:
    """Operations of one GRU direction's forward over [T, B]: the gates'
    [H, 2H] and the candidate's [H, H] product a row and step."""
    return T * (2 * B * H * 2 * H + 2 * B * H * H)


def check_gru_kernels(params, cfg, dev, record: Recorder) -> None:
    """Phase 3, kernels #6 and #7 on encoder layer 1 of the GRU flagship
    (`-gru`), each held to its plain version at the serving shape (T=512,
    B=8) and the train shape (T=384, B=128): #6 both directions in one
    launch (inference; its row at the serving shape), one direction with
    the carry mask and the training form (rows at the train shape), #7
    both directions and one direction with the mask (rows at the train
    shape). The row's other shape is timed too (`*_shape_ms`). Library:
    none. cuDNN's nn.GRU applies r after the recurrent product (linear
    before reset), TF-1's GRUCell before it: another function, timed
    beside as `cudnn_nn_gru_ms` only as a cost comparison."""
    rng = np.random.default_rng(13)
    H = cfg.encoder.hidden_size
    cases = {"serving": gru_layer_case(params, cfg, dev, rng, 512, 8),
             "train": gru_layer_case(params, cfg, dev, rng, TRAIN_T,
                                     TRAIN_B)}
    fwd_src = "e2e_asr_tpu_torch/csrc/gru_seq.cu"
    bwd_src = "e2e_asr_tpu_torch/csrc/gru_bwd.cu"
    fwd_pallas = "e2e_asr_tpu/ops/gru_pallas.py:174"
    bwd_pallas = "e2e_asr_tpu/ops/gru_pallas.py:355"

    def bidir_plain(c):
        gx_fw, cx_fw, gx_bw, cx_bw, wg_fw, wc_fw, wg_bw, wc_bw, m = c
        return (gru_seq.gru_seq_reference(gx_fw, cx_fw, wg_fw, wc_fw),
                gru_seq.gru_seq_reference(gx_bw, cx_bw, wg_bw, wc_bw, m))

    def bidir_train_plain(c):
        gx_fw, cx_fw, gx_bw, cx_bw, wg_fw, wc_fw, wg_bw, wc_bw, m = c
        return (*gru_seq.gru_seq_reference(gx_fw, cx_fw, wg_fw, wc_fw,
                                           save=True),
                *gru_seq.gru_seq_reference(gx_bw, cx_bw, wg_bw, wc_bw, m,
                                           save=True))

    def flat(pairs):
        return [t for p in pairs for t in p]

    # name, its row's shape, source, TPU kernel, kernel(case),
    # plain(case), inputs(case), directions, cuDNN (bidirectional,
    # backward). The backward's operations are twice the forward's: d(rh),
    # dh, dW_gh and dW_ch (r | u and c are saved, not recomputed).
    rows = [
        ("gru_bidir", "serving", fwd_src, fwd_pallas,
         lambda c: gru_seq.gru_seq_bidir(*c["bidir"]),
         lambda c: bidir_plain(c["bidir"]), lambda c: c["bidir"], 2,
         (True, False)),
        ("gru_seq_masked", "train", fwd_src, fwd_pallas,
         lambda c: [gru_seq.gru_seq(*c["masked"])],
         lambda c: [gru_seq.gru_seq_reference(*c["masked"])],
         lambda c: c["masked"], 1, (False, False)),
        ("gru_bidir_train", "train", fwd_src, fwd_pallas,
         lambda c: flat(gru_seq.gru_seq_bidir_train(*c["bidir"])),
         lambda c: bidir_train_plain(c["bidir"]), lambda c: c["bidir"], 2,
         (True, False)),
        ("gru_bidir_bwd", "train", bwd_src, bwd_pallas,
         lambda c: flat(gru_seq.gru_bidir_bwd(c["bwd_fw"], c["bwd_bw"])),
         lambda c: [*gru_seq.gru_bwd_reference(*c["bwd_fw"]),
                    *gru_seq.gru_bwd_reference(*c["bwd_bw"])],
         lambda c: c["bwd_fw"] + c["bwd_bw"], 2, (True, True)),
        ("gru_bwd", "train", bwd_src, bwd_pallas,
         lambda c: gru_seq.gru_bwd(*c["bwd_bw"]),
         lambda c: gru_seq.gru_bwd_reference(*c["bwd_bw"]),
         lambda c: c["bwd_bw"], 1, (False, True)),
    ]
    with torch.no_grad():
        for (name, shape, src, pallas, kernel, plain, inputs, dirs,
             (both, backward)) in rows:
            other = "train" if shape == "serving" else "serving"
            oc = cases[other]
            abs_err, _, _ = Recorder.hold(name, kernel(oc), plain(oc))
            T, B = oc["x"].shape[:2]
            other_ms = time_ms(lambda: kernel(oc), 5)
            print(f"kernel {name} at T={T} B={B}: max_abs_err={abs_err:.3e} "
                  f"kernel_ms={other_ms:.4f}", flush=True)
            c = cases[shape]
            T, B = c["x"].shape[:2]
            got = kernel(c)
            ops = dirs * gru_ops(T, B, H) * (2 if backward else 1)
            with torch.enable_grad():
                cudnn_ms = cudnn_lstm_ms(c["x"], c["lens"], H, both,
                                         backward, rnn=torch.nn.GRU)
            record(name, src, pallas, got, plain(c), lambda: kernel(c),
                   lambda: plain(c), 5 if B > 8 else 20, 1,
                   (ops, nbytes(*inputs(c), *got)), None,
                   **{f"{other}_shape_ms": other_ms,
                      "cudnn_nn_gru_ms": cudnn_ms})
    print("gru kernels: library none (cuDNN's nn.GRU computes another "
          "function: r applied after the recurrent product); "
          "cudnn_nn_gru_ms is its time on the same shape, a cost "
          "comparison only", flush=True)


def check_dec_train_gru(params, cfg, dev, record: Recorder) -> None:
    """Phase 3, kernel #10 at the GRU step's own shapes: B=128, 47 steps,
    the char decoder (V=40) on 48 encoder frames and the phone decoder
    (V=46) on encoder layer 3's 96, scheduled sampling on every other step
    and dropout."""
    rng = np.random.default_rng(14)
    H = cfg.encoder.hidden_size
    B, S = TRAIN_B, TRAIN_L - 1
    for task, Te, suffix in (("char", TRAIN_T // 8, ""),
                             ("phone", TRAIN_T // 4, "_phone")):
        dec, dcfg = params[f"decoder_{task}"], cfg.decoders[task]
        rand = lambda *s, scale=1.0: torch.tensor(  # noqa: E731
            rng.normal(size=s).astype(np.float32) * scale, device=dev)
        enc = rand(B, Te, 2 * H, scale=0.5)
        enc_lens = torch.tensor(rng.integers(Te // 2, Te + 1, size=B),
                                device=dev)
        enc_lens[0] = Te
        ids = torch.tensor(rng.integers(3, dcfg.vocab_size, size=(S + 1, B)),
                           device=dev)
        gen = torch.Generator(device=dev).manual_seed(14)
        _, gumbel, lm_masks, _ = attn_decoder.train_noise(gen, dcfg, S, B,
                                                          dev)
        flags = (torch.arange(S, device=dev) % 2).float()
        M, G = dcfg.emb_size, dcfg.lm_hidden_size
        lm = dec["lm_cell"]
        with torch.no_grad():
            x = dec["embedding"][ids][:S]
            tgx = x @ lm["gates"]["kernel"][:M] + lm["gates"]["bias"]
            tcx = x @ lm["candidate"]["kernel"][:M] + lm["candidate"]["bias"]
            weights = [w.contiguous() for w in dec_train_gru.weight_args(
                dec, M)]
            hf = enc @ dec["attn_w"]
        amask = (torch.arange(Te, device=dev)[None, :]
                 < enc_lens[:, None]).float()
        gum_sh = torch.cat([gumbel.new_zeros(1, B, dcfg.vocab_size),
                            gumbel[:-1]])
        flag_sh = torch.cat([flags.new_zeros(1), flags[:-1]])[:, None].expand(
            S, B).contiguous()
        leaves = [t.detach().requires_grad_(True)
                  for t in (*weights, hf, enc, tgx, tcx)]
        args = (leaves[:19], *leaves[19:21], amask, *leaves[21:], gum_sh,
                flag_sh, lm_masks)
        logits = dec_train_gru.dec_train_gru(*args)
        tokens = dec_train.sampled_tokens(logits.detach(), gum_sh)
        with torch.no_grad():
            free = dec_train_gru.dec_train_gru_reference(*args)
        parted = near_tie_partings(f"dec_train_gru {task}", free, tokens,
                                   gum_sh, flag_sh)

        def plain():
            return dec_train_gru.dec_train_gru_reference(*args,
                                                         sampled=tokens)

        D, E, A, V = (dcfg.hidden_size_dec, 2 * H, dcfg.attention_vec_size,
                      dcfg.vocab_size)
        products = (G * 2 * G + G * G + (G + E) * M + (M + D) * 2 * D
                    + M * D + D * D + D * A + (D + E) * D + D * V)
        attn = Te * A * 3 + Te * E * 2
        inputs = nbytes(*leaves, amask, gum_sh, flag_sh, lm_masks)
        src = "e2e_asr_tpu_torch/csrc/dec_train_gru.cu"
        pallas = "e2e_asr_tpu/ops/dec_train_gru_pallas.py"
        with torch.no_grad():
            record(f"dec_train_gru_fwd{suffix}", src, f"{pallas}:323",
                   [logits.detach()], [plain()],
                   lambda: dec_train_gru.dec_train_gru(*args), plain, 5, 2,
                   (S * B * (2 * products + attn), inputs + nbytes(logits)),
                   near_tie_rows=parted)
        dlog = rand(S, B, V)
        got = torch.autograd.grad(logits, leaves, dlog, retain_graph=True)
        want_out = plain()
        want = torch.autograd.grad(want_out, leaves, dlog, retain_graph=True)
        # The data gradients, then the weight gradients: twice the
        # forward's products and about three times its attention work,
        # reading the forward's saves (6G + M + 6D + A + Te + E + V floats
        # a row and step).
        saves = S * B * 4 * (6 * G + M + 6 * D + A + Te + E + V)
        record(f"dec_train_gru_bwd{suffix}", src, f"{pallas}:613", got, want,
               lambda: torch.autograd.grad(logits, leaves, dlog,
                                           retain_graph=True),
               lambda: torch.autograd.grad(want_out, leaves, dlog,
                                           retain_graph=True), 5, 2,
               (S * B * (4 * products + 3 * attn),
                inputs + nbytes(dlog, *got) + saves))


def check_cells_gru(params, cfg, dev, record: Recorder) -> None:
    """Phase 3, kernel #11's GRU branch at the serving shape (N = 8 rows x
    4 beams = 32) on the `-gru` flagship's char decoder (L=1), and on a
    decoder of the same widths with two GRU layers and SimpleProjection
    (lm_hidden 384; held to its plain version and timed as
    `l2_simple_proj_ms`). Library: none."""
    rng = np.random.default_rng(15)
    rand = lambda *s, scale=1.0: torch.tensor(  # noqa: E731
        rng.normal(size=s).astype(np.float32) * scale, device=dev)
    dcfg = cfg.decoders["char"]
    deep_cfg = dataclasses.replace(dcfg, num_layers_dec=2, lm_hidden_size=384)
    N, Henc = 32, 2 * cfg.encoder.hidden_size
    cases = []
    for dec, c in ((params["decoder_char"], dcfg),
                   (attn_decoder.init(torch.Generator().manual_seed(15),
                                      deep_cfg, Henc, device=dev),
                    deep_cfg)):
        tokens = torch.tensor(rng.integers(0, c.vocab_size, size=N),
                              device=dev)
        args = (dec, dec["embedding"][tokens], rand(N, Henc, scale=0.3),
                rand(N, c.lm_hidden_size, scale=0.5),
                tuple(rand(N, c.hidden_size_dec, scale=0.5)
                      for _ in range(c.num_layers_dec)))
        cases.append((dec, args))

    def kernel(args):
        lm, dec_states, y = dec_step.cells_fused(*args, use_lstm=False)
        return [lm, *dec_states, y]

    def plain(args):
        lm, dec_states, y = dec_step.cells_fused_reference(*args,
                                                           use_lstm=False)
        return [lm, *dec_states, y]

    (dec, args), (deep, deep_args) = cases
    abs_err, _, _ = Recorder.hold("cells_fused_gru", kernel(deep_args),
                                  plain(deep_args))
    deep_ms = time_ms(lambda: kernel(deep_args), 200)
    print(f"kernel cells_fused_gru with 2 layers and SimpleProjection: "
          f"max_abs_err={abs_err:.3e} kernel_ms={deep_ms:.4f}", flush=True)
    weights = [w for key, w in checkpoint.flatten_named(dec).items()
               if key.startswith(("lm_cell", "input_proj", "attn_query",
                                  "dec_cells"))]
    got = kernel(args)
    record("cells_fused_gru", "e2e_asr_tpu_torch/csrc/dec_step.cu",
           "e2e_asr_tpu/ops/dec_step_pallas.py:208", got, plain(args),
           lambda: kernel(args), lambda: plain(args), 200, 50,
           (2 * N * sum(w.numel() for w in weights if w.dim() == 2),
            nbytes(*weights, *args[1:4], *args[4], *got)),
           l2_simple_proj_ms=deep_ms)


def attn_output_case(dec, dcfg, rng, dev, B: int, k: int, Henc: int):
    """Kernel #13's inputs for B utterances x k beams over MEGA_T encoder
    frames (lengths MEGA_T/2..MEGA_T, the first MEGA_T): the query
    projection y and the query, hf, enc and the mask."""
    rand = lambda *s, scale=1.0: torch.tensor(  # noqa: E731
        rng.normal(size=s).astype(np.float32) * scale, device=dev)
    lens = torch.tensor(rng.integers(MEGA_T // 2, MEGA_T + 1, size=B),
                        device=dev)
    lens[0] = MEGA_T
    ctx = attn_decoder.make_attn_context(dec, rand(B, MEGA_T, Henc,
                                                   scale=0.5), lens)
    N = B * k
    return (dec, dcfg, rand(N, dcfg.attention_vec_size),
            rand(N, dcfg.hidden_size_dec, scale=0.5), ctx.hidden_features,
            ctx.enc_states, ctx.mask)


def check_attn_output(params, cfg, gru_params, gru_cfg, dev,
                      record: Recorder) -> None:
    """Phase 3, kernel #13 at the beam step's shape (B=8, k=4, T=64 encoder
    frames of width 512) with the flagship's LSTM decoder (its query the
    top c), the same with the `-gru` flagship's GRU decoder (the top h;
    `gru_query_ms`) and at the greedy step's shape (k=1, B=64;
    `greedy_b64_ms`), each held to its plain version; beside each, the
    route it replaces on the same inputs: the plain attention
    (attn_output.attend) and kernel C (`unfused_ms`,
    `gru_unfused_ms`, `greedy_b64_unfused_ms`). Library: none."""
    rng = np.random.default_rng(16)
    Henc = 2 * cfg.encoder.hidden_size
    runs = {}
    for label, p, c, B, k in (
            ("lstm", params, cfg, 8, 4), ("gru", gru_params, gru_cfg, 8, 4),
            ("greedy_b64", params, cfg, 64, 1)):
        case = attn_output_case(p["decoder_char"], c.decoders["char"], rng,
                                dev, B, k, Henc)

        def unfused(a=case, k=k):
            dec, dcfg, y, query, hf, enc, mask = a
            context, _ = attn_output.attend(dec, y, hf, enc, mask, k=k)
            return dec_step.output_fused(dec, dcfg, query, context)

        runs[label] = (
            case, k, lambda a=case, k=k: attn_output.attn_output_fused(
                *a, k=k),
            lambda a=case, k=k: attn_output.attn_output_fused_reference(
                *a, k=k), time_ms(unfused, 200))
    for label in ("gru", "greedy_b64"):
        case, k, kernel, plain, unfused_ms = runs[label]
        abs_err, _, _ = Recorder.hold("attn_output_fused", kernel(), plain())
        print(f"kernel attn_output_fused {label}: max_abs_err={abs_err:.3e} "
              f"kernel_ms={time_ms(kernel, 200):.4f} "
              f"unfused_ms={unfused_ms:.4f}", flush=True)
    case, k, kernel, plain, unfused_ms = runs["lstm"]
    dec, dcfg, y, query, hf, enc, mask = case
    N, A = y.shape
    T, H, V = hf.shape[1], query.shape[1], dcfg.vocab_size
    weights = [dec["attn_v"], *(dec[n][p] for n in ("attn_proj",
                                                    "output_proj")
                                for p in ("kernel", "bias"))]
    got = kernel()
    record("attn_output_fused", "e2e_asr_tpu_torch/csrc/attn_output.cu",
           "e2e_asr_tpu/ops/dec_step_pallas.py:309", got, plain(), kernel,
           plain, 200, 50,
           (N * T * (4 * A + 2 * Henc + 4) + 2 * N * (H + Henc) * H
            + 2 * N * H * V + 4 * N * V,
            nbytes(y, query, hf, enc, mask, *weights, *got)),
           unfused_ms=unfused_ms,
           gru_query_ms=time_ms(runs["gru"][2], 200),
           gru_unfused_ms=runs["gru"][4],
           greedy_b64_ms=time_ms(runs["greedy_b64"][2], 200),
           greedy_b64_unfused_ms=runs["greedy_b64"][4])


def serve(params, cfg, dev, rev_vocab) -> tuple[list, list, dict]:
    """Phase 4a: 24 requests through the batching engine."""
    rng = np.random.default_rng(2)
    lengths = rng.permutation(np.linspace(40, 512, 24).astype(int))
    feats = [rng.normal(size=(n, cfg.feat_length)).astype(np.float32)
             for n in lengths]
    sent, done = {}, {}
    t0 = time.monotonic()
    with BatchingTranscriber(params, cfg, rev_vocab, device=dev,
                             beam_cfg=BeamConfig(beam_size=4, max_steps=120),
                             bucket_frames=(128, 256, 512),
                             max_batch=8) as engine:
        futures = []
        for i, x in enumerate(feats):
            sent[i] = time.monotonic()
            fut = engine.submit(x)
            fut.add_done_callback(
                lambda _, i=i: done.__setitem__(i, time.monotonic()))
            futures.append(fut)
        texts = [f.result(timeout=600) for f in futures]
    wall = time.monotonic() - t0
    lat = np.array([done[i] - sent[i] for i in range(len(feats))]) * 1e3
    stats = {"requests": engine.stats.requests,
             "batches": engine.stats.batches,
             "mean_occupancy": engine.stats.mean_occupancy,
             "wall_s": wall, "p50_latency_ms": float(np.percentile(lat, 50)),
             "p90_latency_ms": float(np.percentile(lat, 90))}
    return feats, texts, stats


def recorded_selections(decode):
    """decode() with every beam_select call's results kept (on the host):
    (decode()'s outputs on the host, the selections of each step)."""
    select = beam_select.beam_select
    steps = []

    def recording(*args, **kw):
        out = select(*args, **kw)
        steps.append({k: v.cpu() for k, v in out.items()})
        return out

    beam_select.beam_select = recording
    try:
        out = [t.cpu() for t in decode()]
    finally:
        beam_select.beam_select = select
    return out, steps


def hold_beam_runs(what: str, run_a, run_b, V: int) -> None:
    """Hold two per-step beam decodes of one batch to each other (runs of
    recorded_selections): every row equal, or parting at a near-tie of the
    selection scores in the step where it parts."""
    (tok_a, len_a, sc_a), steps_a = run_a
    (tok_b, len_b, sc_b), steps_b = run_b
    B = tok_a.shape[0]
    for name, t in (("tokens", tok_a), ("scores", sc_a)):
        if not torch.isfinite(t.float()).all():
            fail(f"{what}: non-finite {name}")
    if not ((tok_a >= 0) & (tok_a < V)).all():
        fail(f"{what}: bad token array {tuple(tok_a.shape)}")
    for b in range(B):
        part = None
        for s, (g, c) in enumerate(zip(steps_a, steps_b)):
            if not all(torch.equal(g[k][b], c[k][b]) for k in
                       ("parent", "token", "order", "fin_dest")):
                part = s
                break
            if (g["vals"][b] - c["vals"][b]).abs().max() > NEAR_TIE:
                fail(f"{what} row {b} step {s}: selection scores differ by "
                     f"more than {NEAR_TIE} before any divergence")
        if part is None:
            if not (torch.equal(tok_a[b], tok_b[b])
                    and int(len_a[b]) == int(len_b[b])):
                fail(f"{what} row {b}: same selections but different "
                     "outputs")
            continue
        g, c = steps_a[part], steps_b[part]
        r = next(r for r in range(g["parent"].shape[1])
                 if (g["parent"][b, r], g["token"][b, r])
                 != (c["parent"][b, r], c["token"][b, r]))
        gap = float((g["vals"][b, r] - c["vals"][b, r]).abs())
        print(f"{what} row {b}: the runs part at step {part} rank {r}, "
              f"selection-score gap {gap:.3e} (near-tie limit {NEAR_TIE})")
        if gap >= NEAR_TIE:
            fail(f"{what} row {b} diverges at step {part} by {gap}")
    same = int(sum(torch.equal(tok_a[b], tok_b[b]) for b in range(B)))
    print(f"{what}: {same}/{B} rows identical; max score diff "
          f"{float((sc_a - sc_b).abs().max()):.3e}", flush=True)


def compare_cpu(params, cfg, feats) -> None:
    """Phase 4b: one batch on the card vs the plain path on the CPU."""
    reqs = feats[:8]
    T = max(x.shape[0] for x in reqs)
    bucket = next(b for b in (128, 256, 512) if T <= b)
    batch = {"logmel": np.zeros((8, bucket, cfg.feat_length), np.float32),
             "logmel_len": np.array([x.shape[0] for x in reqs])}
    for i, x in enumerate(reqs):
        batch["logmel"][i, :x.shape[0]] = x
    decode = beam_eval.make_beam_decoder(cfg, BeamConfig(beam_size=4,
                                                         max_steps=120))
    runs = {}
    for name, p in (("cuda", params), ("cpu", to_device(params, "cpu"))):
        t0 = time.monotonic()
        runs[name] = recorded_selections(lambda p=p: decode(p, batch))
        print(f"decode on {name}: {len(runs[name][1])} steps, "
              f"{time.monotonic() - t0:.3f} s", flush=True)
    if runs["cuda"][0][0].shape != (8, 120):
        fail(f"bad token array {tuple(runs['cuda'][0][0].shape)}")
    hold_beam_runs("cuda vs cpu", runs["cuda"], runs["cpu"],
                   cfg.decoders["char"].vocab_size)


# Each kernel row's launch counter (module, name). lstm_bwd and lstm_bwd_lm
# are kernel #5 at the ASR and the LM shape: one counter.
COUNTERS = {"lstm_bidir": (lstm_bidir, "LAUNCHES"),
            "cells_fused": (dec_step, "CELLS_LAUNCHES"),
            "output_fused": (dec_step, "OUTPUT_LAUNCHES"),
            "beam_select": (beam_select, "LAUNCHES"),
            "lstm_bidir_train": (lstm_bidir, "TRAIN_LAUNCHES"),
            "lstm_bidir_bwd": (lstm_bidir, "BWD_LAUNCHES"),
            "lstm_bwd": (lstm_bidir, "BWD_SINGLE_LAUNCHES"),
            "dec_train_fwd": (dec_train, "FWD_LAUNCHES"),
            "dec_train_bwd": (dec_train, "BWD_LAUNCHES"),
            "lstm_seq": (lstm_seq, "LAUNCHES"),
            "lstm_seq_masked": (lstm_seq, "MASKED_LAUNCHES"),
            "lstm_seq_train": (lstm_seq, "TRAIN_LAUNCHES"),
            "lstm_bwd_lm": (lstm_bidir, "BWD_SINGLE_LAUNCHES"),
            "beam_mega": (beam_mega, "LAUNCHES"),
            "gru_bidir": (gru_seq, "LAUNCHES"),
            "gru_seq_masked": (gru_seq, "MASKED_LAUNCHES"),
            "gru_bidir_train": (gru_seq, "TRAIN_LAUNCHES"),
            "gru_bidir_bwd": (gru_seq, "BWD_LAUNCHES"),
            "gru_bwd": (gru_seq, "BWD_SINGLE_LAUNCHES"),
            "dec_train_gru_fwd": (dec_train_gru, "FWD_LAUNCHES"),
            "dec_train_gru_bwd": (dec_train_gru, "BWD_LAUNCHES"),
            "dec_train_gru_fwd_phone": (dec_train_gru, "FWD_LAUNCHES"),
            "dec_train_gru_bwd_phone": (dec_train_gru, "BWD_LAUNCHES"),
            "cells_fused_gru": (dec_step, "CELLS_GRU_LAUNCHES"),
            "beam_mega_gru": (beam_mega, "GRU_LAUNCHES"),
            "attn_output_fused": (attn_output, "LAUNCHES")}
# The kernels each main path must launch. The ASR step takes both
# directions of A's backward in one launch (lstm_bidir_bwd), never
# lstm_bwd; the LM step's kernel #3 has no mask, and its backward is #5.
# The GRU encoder's layers take #6 both directions in one launch and #7
# likewise (a GRU layer's one-direction forms, gru_seq_masked and gru_bwd,
# serve forward-only layers, which no configuration here has). Rows of one
# counter (lstm_bwd and lstm_bwd_lm, #10's char and phone rows) count the
# same launches.
SERVING_PATH = ("lstm_bidir", "cells_fused", "output_fused", "beam_select")
TRAIN_PATH = ("lstm_bidir_train", "lstm_bidir_bwd", "dec_train_fwd",
              "dec_train_bwd")
LM_PATH = ("lstm_seq_train", "lstm_bwd")
RECIPE_PATH = TRAIN_PATH + LM_PATH + ("lstm_bidir", "cells_fused",
                                      "output_fused")
GRU_TRAIN_PATH = ("gru_bidir_train", "gru_bidir_bwd", "dec_train_gru_fwd",
                  "dec_train_gru_bwd")
MIX_SERVING_PATH = ("gru_bidir",) + SERVING_PATH[1:]
MIX_RECIPE_PATH = (GRU_TRAIN_PATH[:2] + TRAIN_PATH[2:] + LM_PATH
                   + ("gru_bidir", "cells_fused", "output_fused"))
GRU_SERVING_PATH = ("gru_bidir", "cells_fused_gru") + SERVING_PATH[2:]
GRU_RECIPE_PATH = GRU_TRAIN_PATH + ("gru_bidir", "cells_fused_gru",
                                    "output_fused")


def decode_rows(gru_decoder: bool) -> tuple[str, str]:
    """The rows of kernels #11 and #15 for a decoder's cells."""
    return (("cells_fused_gru", "beam_mega_gru") if gru_decoder
            else ("cells_fused", "beam_mega"))


def zero_launches() -> None:
    for module, counter in COUNTERS.values():
        setattr(module, counter, 0)


def read_launches(path: str, required) -> dict:
    """Every counter after a main-path run; fails if a kernel the path
    must launch was not launched."""
    launches = {name: getattr(m, c) for name, (m, c) in COUNTERS.items()}
    print(f"launches in the {path} run: {json.dumps(launches)}", flush=True)
    for name in required:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the {path} path")
    return launches


def train_batch(rng, B: int, cfg) -> dict:
    """B utterances of up to TRAIN_T frames with transcripts of up to
    TRAIN_L - 1 tokens of each task (ending in <eos>), random from `rng`."""
    T, L = TRAIN_T, TRAIN_L
    lens = rng.integers(T // 2, T + 1, size=B)
    lens[0] = T
    batch = {"logmel_len": lens}
    for task in cfg.tasks:
        V = cfg.decoders[task].vocab_size
        task_len = rng.integers(L // 2, L, size=B)
        task_len[0] = L - 1
        ids = np.zeros((B, L), np.int64)
        ids[:, 0] = GO_ID
        for i, n in enumerate(task_len):
            ids[i, 1:n] = rng.integers(3, V, size=n - 1)
            ids[i, n] = EOS_ID
        batch[task], batch[f"{task}_len"] = ids, task_len
    feats = rng.normal(size=(B, T, cfg.feat_length)).astype(np.float32)
    feats[np.arange(T)[None, :] >= lens[:, None]] = 0.0
    batch["logmel"] = feats
    return batch


def compare_train_step(cfg, dev, lm_cfg) -> None:
    """Phase 5a: one asr_step at B=16 on the card and on the CPU, same
    params, batch and noise; teacher forcing (no sampled token can part)."""
    cfg = dataclasses.replace(cfg, decoders={
        t: dataclasses.replace(d, samp_prob=0.0)
        for t, d in cfg.decoders.items()})
    B = 16
    batch = train_batch(np.random.default_rng(5), B, cfg)
    gen = torch.Generator().manual_seed(5)
    params = seq2seq.init(gen, cfg, device="cpu")
    masks, t = {}, TRAIN_T
    for i, reduce in enumerate(encoder.layer_plan(cfg.encoder, 4)):
        masks[i + 1] = dropout_mask(gen, (t, B, 2 * cfg.encoder.hidden_size),
                                    cfg.encoder.out_prob, "cpu")
        t = -(-t // cfg.encoder.skip_step) if reduce else t
    noise = {"encoder": masks}
    for task, dcfg in cfg.decoders.items():
        noise[task] = attn_decoder.train_noise(gen, dcfg, TRAIN_L - 1, B,
                                               "cpu")
    runs = []
    for where in ("cpu", dev):
        asr_step, _ = step.make_train_step(cfg, lm_cfg, device=where)
        state = step.create_state(params, cfg, lm_cfg, device=where)
        t0 = time.monotonic()
        loss, _, grads = asr_step.loss_and_grads(state.params, batch, None,
                                                 noise)
        new_state, _ = asr_step(state, batch, None, noise)
        runs.append((float(loss), named_from_params(grads),
                     named_from_params(new_state.params)))
        print(f"asr_step B={B} on {where}: loss {float(loss):.6f}, "
              f"{time.monotonic() - t0:.2f} s", flush=True)
    compare_runs("asr_step", B, *runs)


def compare_runs(what: str, B: int, cpu_run, card_run) -> None:
    """Hold a step on the card to the same step on the CPU: runs of (loss,
    named gradients, named params after the step)."""
    (loss_c, g_c, p_c), (loss_g, g_g, p_g) = cpu_run, card_run
    # Tolerances: loss 1e-5 relative; gradients 1e-3 relative to each
    # leaf's largest value (sums over 384-step recurrences in other
    # orders); params 1e-5 (1% of one Adam step at lr 1e-3) where |g| is
    # above 1% of its leaf's largest.
    if not abs(loss_g - loss_c) <= 1e-5 * abs(loss_c):
        fail(f"{what}: loss on the card {loss_g} vs the CPU {loss_c}")
    worst_g = worst_p = 0.0
    for name, w in g_c.items():
        scale = max(float(np.abs(w).max()), 1e-12)
        worst_g = max(worst_g, float(np.abs(g_g[name] - w).max()) / scale)
        big = np.abs(w) > 1e-2 * scale
        if big.any():
            worst_p = max(worst_p, float(np.abs(p_g[name][big]
                                                - p_c[name][big]).max()))
    print(f"{what} card vs CPU at B={B}: loss {loss_g:.6f} vs {loss_c:.6f}; "
          f"gradients max error {worst_g:.3e} of each leaf's largest "
          f"(tolerance 1e-3); params after the step max error "
          f"{worst_p:.3e} (tolerance 1e-5)", flush=True)
    if not (worst_g <= 1e-3 and worst_p <= 1e-5):
        fail(f"the card's {what} disagrees with the CPU's")


def train(cfg, dev, card: str, path=None, label: str = "training") -> dict:
    """Phase 5: (a) card vs CPU at B=16, (b) three steps at the bench's
    train shape, every kernel of `path` launched, (c) their time. Returns
    the launches of the training kernels in (b) alone."""
    lm_cfg = LMConfig(vocab_size=cfg.decoders["char"].vocab_size)
    compare_train_step(cfg, dev, lm_cfg)
    params = seq2seq.init(torch.Generator().manual_seed(0), cfg, device=dev)
    asr_step, _ = step.make_train_step(cfg, lm_cfg, device=dev)
    state = step.create_state(params, cfg, lm_cfg, device=dev)
    batch = train_batch(np.random.default_rng(6), TRAIN_B, cfg)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    gen = torch.Generator(device=dev).manual_seed(6)
    zero_launches()
    times, losses = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = asr_step(state, batch, gen)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = read_launches(label, path or TRAIN_PATH)
    if not all(np.isfinite(losses)) or int(state.global_step) != 3:
        fail(f"training losses {losses}, global_step "
             f"{int(state.global_step)}")
    frames = int(batch["logmel_len"].sum())
    steady = float(np.mean(times[1:]))
    print(f"{label} B={TRAIN_B} T={TRAIN_T} L={TRAIN_L} ({card}): losses "
          f"{losses}; step times {[round(t * 1e3, 2) for t in times]} ms; "
          f"steady step {steady * 1e3:.2f} ms, {frames / steady:.0f} "
          f"frames/s ({TRAIN_B * TRAIN_T / steady:.0f} padded frames/s)",
          flush=True)
    return launches


TIED = ("decoder_char/lm_cell/", "decoder_char/output_proj/",
        "decoder_char/embedding")   # the leaves the LM shares


def compare_lm_step(cfg, dev, lm_cfg) -> None:
    """Phase 5 (LM) a: one lm_step at B=16 on the card and on the CPU, same
    params, batch (a padded tail row among them) and dropout mask; on the
    card every leaf the LM does not share keeps its bits."""
    B = 16
    ids, lens, valid = lm_batch(np.random.default_rng(8), B,
                                cfg.decoders["char"].vocab_size)
    valid[-1] = 0.0
    gen = torch.Generator().manual_seed(8)
    params = seq2seq.init(gen, cfg, device="cpu")
    noise = dropout_mask(gen, (LM_T, B, cfg.decoders["char"].lm_hidden_size),
                         lm_cfg.out_prob, "cpu")
    before = named_from_params(params)
    runs = []
    for where in ("cpu", dev):
        _, lm_step = step.make_train_step(cfg, lm_cfg, device=where)
        state = step.create_state(params, cfg, lm_cfg, device=where)
        t0 = time.monotonic()
        loss, grads = lm_step.loss_and_grads(state.params, ids, lens, None,
                                             valid, noise)
        new_state, _ = lm_step(state, ids, lens, None, valid, noise)
        runs.append((float(loss), named_from_params(grads),
                     named_from_params(new_state.params)))
        print(f"lm_step B={B} on {where}: loss {float(loss):.6f}, "
              f"{time.monotonic() - t0:.2f} s", flush=True)
    compare_runs("lm_step", B, *runs)
    after = runs[1][2]
    moved = {k for k in before if not np.array_equal(after[k], before[k])}
    tied = {k for k in before if k.startswith(TIED)}
    print(f"lm_step on the card: {len(moved)} leaves moved (the {len(tied)} "
          f"tied ones), {len(before) - len(moved)} kept their bits",
          flush=True)
    if moved != tied:
        fail(f"the LM step moved {sorted(moved ^ tied)} against the tying")


def timed_steps(run, n: int) -> tuple[list, list]:
    """n calls of run() -> loss; (losses, host times ending in a sync)."""
    losses, times = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(run()))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return losses, times


def train_lm_multitask(dev, card) -> dict:
    """Phase 5 (LM, multitask): (a) lm_step card vs CPU; (b) three
    asr_steps of the char + phone model at B=128, T=384, L=48 and three
    lm_steps at B=128, T=120, counted from zero; (c) their times. Returns
    the launches of (b)."""
    cfg = flagship_cfg(40, PHONE_VOCAB)
    lm_cfg = LMConfig(vocab_size=40)
    compare_lm_step(cfg, dev, lm_cfg)
    params = seq2seq.init(torch.Generator().manual_seed(0), cfg, device=dev)
    asr_step, lm_step = step.make_train_step(cfg, lm_cfg, device=dev)
    holder = {"state": step.create_state(params, cfg, lm_cfg, device=dev)}
    batch = {k: torch.as_tensor(v, device=dev) for k, v in train_batch(
        np.random.default_rng(9), TRAIN_B, cfg).items()}
    ids, lens, valid = (torch.as_tensor(a, device=dev) for a in lm_batch(
        np.random.default_rng(10), LM_B, 40))
    gen = torch.Generator(device=dev).manual_seed(9)

    def one_asr():
        holder["state"], metrics = asr_step(holder["state"], batch, gen)
        return metrics["loss"]

    def one_lm():
        holder["state"], metrics = lm_step(holder["state"], ids, lens, gen,
                                           valid)
        return metrics["lm_loss"]

    zero_launches()
    asr_losses, asr_times = timed_steps(one_asr, 3)
    lm_losses, lm_times = timed_steps(one_lm, 3)
    launches = read_launches("LM and multitask", TRAIN_PATH + LM_PATH)
    state = holder["state"]
    if not (all(np.isfinite(asr_losses + lm_losses))
            and int(state.global_step) == 3
            and int(state.lm_global_step) == 3):
        fail(f"multitask losses {asr_losses}, LM losses {lm_losses}")
    if (launches["dec_train_fwd"], launches["dec_train_bwd"]) != (6, 6):
        fail("the char and phone decoders did not both run kernels #8/#9 "
             "every step")
    frames, tokens = int(batch["logmel_len"].sum()), int(lens.sum())
    asr_s, lm_s = float(np.mean(asr_times[1:])), float(np.mean(lm_times[1:]))
    print(f"multitask (char + phone) B={TRAIN_B} T={TRAIN_T} L={TRAIN_L} "
          f"({card}): losses {asr_losses}; step times "
          f"{[round(t * 1e3, 2) for t in asr_times]} ms; steady step "
          f"{asr_s * 1e3:.2f} ms, {frames / asr_s:.0f} frames/s", flush=True)
    print(f"LM B={LM_B} T={LM_T} ({card}): losses {lm_losses}; step times "
          f"{[round(t * 1e3, 2) for t in lm_times]} ms; steady step "
          f"{lm_s * 1e3:.2f} ms, {tokens / lm_s:.0f} tokens/s", flush=True)
    return launches


def recipe(dev, card, cells: str = "lstm") -> dict:
    """Phase 6: train a synthetic corpus at the flagship shape with the
    port's Trainer, evaluate, save, and resume in a second Trainer
    (`cells` as flagship_cfg's; "gru" trains without the LM task, which a
    GRU char decoder does not have). With GRU cells, then also evaluate
    the trained model on the dev set through BeamEvaluator (beam 4) at a
    batch of 1 (one #15 launch per utterance) and, with GRU decoders, at a
    batch of 64 (the per-step route). Returns the launches of each run."""
    with tempfile.TemporaryDirectory() as root:
        t0 = time.monotonic()
        sizes = synth.make_vocab_dir(os.path.join(root, "vocab"))
        data = os.path.join(root, "data")
        os.makedirs(os.path.join(data, "lm"))
        utt = dict(feat_length=80, min_tokens=24, max_tokens=47,
                   frames_per_token=8)
        synth.write_speech_corpus(os.path.join(data, "train_1k.0.0001"), 384,
                                  seed=0, **utt)
        synth.write_speech_corpus(os.path.join(data, "dev.0001"), 64, seed=1,
                                  **utt)
        synth.write_lm_corpus(os.path.join(data, "lm", "lm.0001"), 256,
                              seed=2, min_tokens=24, max_tokens=118)
        print(f"recipe corpus: 384 train, 64 dev utterances, 256 LM "
              f"sequences written in {time.monotonic() - t0:.1f} s",
              flush=True)
        train_cfg = TrainConfig(
            batch_size=128, buck_batch_size=[128], num_buckets=1,
            max_epochs=1, min_steps=0, feat_length=80, data_dir=data,
            lm_data_dir=os.path.join(data, "lm"),
            vocab_dir=os.path.join(root, "vocab"),
            train_dir=os.path.join(root, "train"),
            best_model_dir=os.path.join(root, "best"),
            lm_prob=0.0 if cells == "gru" else 0.5,
            steps_per_checkpoint=3, compute_dtype="float32")
        cfg = ExperimentConfig(
            model=flagship_cfg(sizes["char"], sizes["phone"], cells),
            train=train_cfg, lm=LMConfig(vocab_size=sizes["char"]))
        name = "recipe" if cells == "lstm" else f"recipe {cells}"
        trainer = Trainer(cfg, device=dev)
        losses = {"asr": [], "lm": []}

        def recording(fn, key, kind):
            def wrapped(*args, **kw):
                new_state, metrics = fn(*args, **kw)
                losses[kind].append(metrics[key])
                return new_state, metrics
            return wrapped

        trainer.asr_step = recording(trainer.asr_step, "loss", "asr")
        trainer.lm_step = recording(trainer.lm_step, "lm_loss", "lm")
        zero_launches()
        t0 = time.monotonic()
        state = trainer.train()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        runs = {name: read_launches(name, {
            "lstm": RECIPE_PATH, "gru_encoder": MIX_RECIPE_PATH,
            "gru": GRU_RECIPE_PATH}[cells])}
        asr = [float(x) for x in losses["asr"]]
        lm = [float(x) for x in losses["lm"]]
        with open(os.path.join(train_cfg.train_dir, "asr_err.txt")) as f:
            errs = [float(x) for x in f.read().split()]
        print(f"{name} ({card}): {int(state.global_step)} ASR steps, "
              f"{int(state.lm_global_step)} LM steps, "
              f"{int(state.lm_epoch)} LM epochs; ASR losses "
              f"{[round(x, 4) for x in asr]}; LM losses "
              f"{[round(x, 4) for x in lm]}; dev WER {errs}; wall "
              f"{wall:.1f} s", flush=True)
        if not (asr and (lm or cells == "gru")
                and np.isfinite(asr + lm).all()):
            fail(f"{name} losses: ASR {asr}, LM {lm}")
        found = checkpoint.restore_latest(train_cfg.train_dir)
        if found is None or len(errs) != 2 or int(state.global_step) != 6:
            fail(f"{name}: {len(errs)} dev evaluations, global step "
                 f"{int(state.global_step)}, checkpoint {found is not None}")
        named = found[0]
        second = Trainer(dataclasses.replace(cfg, train=dataclasses.replace(
            train_cfg, max_epochs=0)), device=dev)
        resumed = step.state_to_named(second.train())
        if not (resumed.keys() == named.keys() and all(
                np.array_equal(resumed[k], v) for k, v in named.items())):
            fail("the second Trainer did not resume the saved state")
        print(f"{name}: checkpoint of step {int(named['global_step'])} "
              f"written and resumed by a second Trainer ({len(named)} "
              f"leaves equal)", flush=True)
        for batch in ((1, 64) if cells == "gru" else
                      (1,) if cells == "gru_encoder" else ()):
            label = f"beam eval {cells} batch {batch}"
            runs[label] = beam_eval_run(cfg, state.params, root, dev, card,
                                        batch, label)
    return runs


def beam_eval_run(cfg, params, root: str, dev, card: str, batch: int,
                  label: str) -> dict:
    """BeamEvaluator over the dev set of a recipe run (64 utterances of a
    GRU encoder's model), beam 4, at a batch of 1 (kernel #15's route, one
    launch an utterance, no per-step kernel) or of 64 (the per-step route:
    #11, #12 and #14, no #15). Returns the launches."""
    dev_set = SpeechDataset([os.path.join(root, "data", "dev.0001")], batch,
                            80, is_training=False, tasks=("char",))
    _, rev_vocab = text.initialize_vocabulary(
        os.path.join(root, "vocab", "char.vocab"))
    out_dir = os.path.join(root, f"beam_{batch}")
    evaluator = beam_eval.BeamEvaluator(
        cfg.model, BeamConfig(beam_size=4, max_steps=120), rev_vocab,
        out_dir, device=dev)
    zero_launches()
    t0 = time.monotonic()
    wer = evaluator(params, dev_set.epoch())
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    cells_row, mega = decode_rows(not cfg.model.decoders["char"].use_lstm)
    per_step = (cells_row, "output_fused", "beam_select")
    route, off = (((mega,), per_step) if batch == 1 else (per_step, (mega,)))
    launches = read_launches(label, ("gru_bidir",) + route)
    if any(launches[k] for k in off) or (
            batch == 1 and launches[mega] != 64):
        fail(f"{label}: {launches[mega]} #15 launches for 64 utterances, "
             f"or a kernel of {off} launched")
    with open(os.path.join(out_dir, "raw_4.txt")) as f:
        if len(f.read().splitlines()) != 64:
            fail(f"{label}: not 64 hypotheses")
    print(f"{label} ({card}): 64 dev utterances, beam 4, WER {wer:.4f}, "
          f"wall {wall:.2f} s", flush=True)
    return launches


def train_gru(dev, card) -> dict:
    """Phase 8: the `-gru` family's char + phone asr_step (GRU encoder and
    decoders, kernels #6, #7 and #10): (a) card vs CPU at B=16, (b) three
    steps at B=128, T=384, L=48, every loss finite, (c) their time, then
    the device-busy share and per-kernel split of one step
    (tools/prof_port.py). Returns the launches of (b)."""
    cfg = flagship_cfg(40, PHONE_VOCAB, "gru")
    launches = train(cfg, dev, card, GRU_TRAIN_PATH,
                     "GRU training (-gru char + phone)")
    if (launches["dec_train_gru_fwd"], launches["dec_train_gru_bwd"]) != (
            6, 6):
        fail("the char and phone GRU decoders did not both run kernel #10 "
             "every step")
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import prof_port
    prof_port.profile_train(cfg, dev, "gru_step")
    return launches


def serve_cells(dev, card, rev_vocab, cells: str) -> dict:
    """Phases 8 and 9: the flagship with GRU cells (`cells` as
    flagship_cfg's: "gru", the `-gru` model; "gru_encoder", a GRU encoder
    under the LSTM decoders; random weights from seed 0) serves 24
    requests, and one batch decoded on the card equals the CPU's up to
    near-ties (as phase 4). Returns the launches."""
    cfg = flagship_cfg(cells=cells)
    params = seq2seq.init(torch.Generator().manual_seed(0), cfg, device=dev)
    with torch.no_grad():
        zero_launches()
        feats, texts, stats = serve(params, cfg, dev, rev_vocab)
        launches = read_launches(f"serving {cells}", (
            GRU_SERVING_PATH if cells == "gru" else MIX_SERVING_PATH))
        print(f"serving {cells} ({card}): {json.dumps(stats)}")
        if len(texts) != 24 or not all(isinstance(t, str) for t in texts):
            fail("not every request got a transcript")
        compare_cpu(params, cfg, feats)
    return launches


def entry_points(dev, card) -> dict:
    """Phase 7: the command line and the serving engine at the flagship
    widths on a synthetic corpus (64 training, 8 dev and 8 test
    utterances of 24-47 tokens at 8 frames a token): (1) `cli.main` trains
    2 steps at a batch of 32 (with a greedy dev evaluation and a save);
    (2) `-dev -beam_size 4 -buck_batch_sizes 1`: one #15 launch per dev
    utterance and no per-step kernel; (3) `-dev` greedy; (4) `-test
    -beam_size 4` at a batch of 64 takes the per-step route; (5)
    grid_search over beam sizes 4 and 16 with one cov_penalty at a batch
    of 1, and its final test evaluation; (6) BatchingTranscriber with
    max_batch=1 serves 8 requests one at a time. Each run counts from
    zero and is held to its route's launches and its output files.
    Returns the launches of each run."""
    runs = {}
    mega = ("beam_mega",)
    per_step = ("cells_fused", "output_fused", "beam_select")
    with tempfile.TemporaryDirectory() as root:
        t0 = time.monotonic()
        vocab, data = os.path.join(root, "vocab"), os.path.join(root, "data")
        synth.make_vocab_dir(vocab)
        os.makedirs(data)
        utt = dict(feat_length=80, min_tokens=24, max_tokens=47,
                   frames_per_token=8)
        for name, n, seed in (("train_1k.0.0001", 64, 3), ("dev.0001", 8, 4),
                              ("eval2000.0001", 8, 5)):
            synth.write_speech_corpus(os.path.join(data, name), n, seed=seed,
                                      **utt)
        print(f"entry points: corpus written in {time.monotonic() - t0:.1f} "
              "s", flush=True)
        base = ["-data_dir", data, "-vocab_dir", vocab, "-tb_dir",
                os.path.join(root, "models"), "-steps_per_checkpoint", "2",
                "-max_epochs", "0", "-compute_dtype", "float32"]
        cfg = cli.parse_options(base + ["-dev"])
        best, train_dir = cfg.train.best_model_dir, cfg.train.train_dir

        def run(name, fn, required, forbidden, launches=None):
            zero_launches()
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            counts = read_launches(name, required)
            for k in forbidden:
                if counts[k]:
                    fail(f"the {name} run launched {k} off its route")
            if launches is not None and counts["beam_mega"] != launches:
                fail(f"the {name} run launched #15 {counts['beam_mega']} "
                     f"times, not {launches}")
            print(f"{name} ({card}): wall {wall:.3f} s", flush=True)
            runs[name] = counts
            return wall

        def lines(path, n):
            with open(path) as f:
                if len(f.read().splitlines()) != n:
                    fail(f"{path}: not {n} lines")

        run("cli train", lambda: cli.main(base + ["-buck_batch_sizes", "32"]),
            TRAIN_PATH + ("lstm_bidir", "cells_fused", "output_fused"), mega)
        if not (os.path.isfile(os.path.join(train_dir, "parameters.txt"))
                and checkpoint.latest_path(train_dir)):
            fail("cli train wrote no parameters.txt or checkpoint")
        wall = run("cli -dev beam 4 batch 1", lambda: cli.main(
            base + ["-dev", "-beam_size", "4", "-buck_batch_sizes", "1"]),
            ("lstm_bidir", "beam_mega"), per_step, launches=8)
        lines(os.path.join(best, "raw_4.txt"), 8)
        print(f"cli -dev beam 4 batch 1: {wall / 8 * 1e3:.1f} ms of wall an "
              "utterance (model restore and data included)")
        run("cli -dev greedy", lambda: cli.main(
            base + ["-dev", "-buck_batch_sizes", "32"]),
            ("lstm_bidir", "cells_fused", "output_fused"),
            ("beam_select", "beam_mega"))
        lines(os.path.join(best, "decoded_asr.txt"), 8)
        run("cli -test beam 4", lambda: cli.main(
            base + ["-test", "-beam_size", "4"]),
            ("lstm_bidir",) + per_step, mega)
        lines(os.path.join(best, "raw_4.txt"), 8)

        # The GRU family (-gru): its own run directory.
        gru = base + ["-gru"]
        gru_best = cli.parse_options(gru + ["-dev"]).train.best_model_dir
        gru_step = ("cells_fused_gru", "output_fused")
        lstm_only = ("lstm_bidir", "cells_fused", "beam_mega")
        run("cli -gru train", lambda: cli.main(
            gru + ["-buck_batch_sizes", "32"]),
            GRU_TRAIN_PATH + ("gru_bidir",) + gru_step,
            lstm_only + ("beam_mega_gru",))
        run("cli -gru -dev greedy", lambda: cli.main(
            gru + ["-dev", "-buck_batch_sizes", "32"]),
            ("gru_bidir",) + gru_step,
            lstm_only + ("beam_select", "beam_mega_gru"))
        lines(os.path.join(gru_best, "decoded_asr.txt"), 8)
        run("cli -gru -test beam 4", lambda: cli.main(
            gru + ["-test", "-beam_size", "4"]),
            ("gru_bidir",) + gru_step + ("beam_select",),
            lstm_only + ("beam_mega_gru",))
        lines(os.path.join(gru_best, "raw_4.txt"), 8)

        named, _ = checkpoint.restore_latest(train_dir)
        params = checkpoint.params_from_named(
            {k[len("params/"):]: v for k, v in named.items()
             if k.startswith("params/")}, cfg.model, dev)
        _, rev_vocab = text.initialize_vocabulary(
            os.path.join(vocab, "char.vocab"))
        one = lambda name: SpeechDataset(  # noqa: E731
            [os.path.join(data, name)], 1, 80, is_training=False,
            tasks=("char",)).epoch
        grid_dir = os.path.join(root, "grid")
        found = {}
        run("beam grid", lambda: found.update(best=beam_grid.grid_search(
            params, cfg.model, rev_vocab, one("dev.0001"), grid_dir,
            beam_sizes=(4, 16), cov_penalties=(0.05,),
            test_batches_fn=one("eval2000.0001"), device=dev)),
            ("lstm_bidir", "beam_mega"), per_step, launches=24)
        lines(os.path.join(grid_dir, "perf.txt"), 2)
        lines(os.path.join(grid_dir, "final_eval", "score.txt"), 1)
        print(f"beam grid: best {found['best'][0].beam_size} at dev WER "
              f"{found['best'][1]:.4f}", flush=True)

        rng = np.random.default_rng(12)
        feats = [rng.normal(size=(n, 80)).astype(np.float32)
                 for n in rng.integers(120, 513, size=8)]
        latency = []

        def serve_one_by_one():
            with BatchingTranscriber(
                    params, cfg.model, rev_vocab, device=dev,
                    beam_cfg=BeamConfig(beam_size=4, max_steps=120),
                    bucket_frames=(128, 256, 512), max_batch=1) as engine:
                for x in feats:
                    t0 = time.monotonic()
                    engine.transcribe(x)
                    latency.append((time.monotonic() - t0) * 1e3)

        run("serving max_batch 1", serve_one_by_one, ("lstm_bidir",) + mega,
            per_step, launches=8)
        print(f"serving max_batch 1 ({card}): 8 requests one at a time, "
              f"latency p50 {np.percentile(latency, 50):.1f} ms, p90 "
              f"{np.percentile(latency, 90):.1f} ms", flush=True)
    return runs


def recorded_logp(decode):
    """decode() with the log-probs of each decoder step kept (on the host),
    from kernel C or from #13: (decode()'s output on the host, the
    log-probs [B, V] of each step)."""
    output, fused = dec_step.output_fused, attn_output.attn_output_fused
    steps = []

    def from_output(*args, **kw):
        logp = output(*args, **kw)
        steps.append(logp.cpu())
        return logp

    def from_fused(*args, **kw):
        out = fused(*args, **kw)
        steps.append(out[0].cpu())
        return out

    dec_step.output_fused = from_output
    attn_output.attn_output_fused = from_fused
    try:
        return decode().cpu(), steps
    finally:
        dec_step.output_fused = output
        attn_output.attn_output_fused = fused


def hold_greedy_runs(what: str, run_a, run_b) -> None:
    """Hold two greedy decodes of one batch to each other (runs of
    recorded_logp): each row's ids equal, or parting at a step whose
    log-probs of the two ids differ by less than NEAR_TIE in run a, with
    the rows' log-probs within NEAR_TIE of each other up to there."""
    (ids_a, logp_a), (ids_b, logp_b) = run_a, run_b
    B = ids_a.shape[0]
    parted = {}
    for b in range(B):
        differ = torch.nonzero(ids_a[b] != ids_b[b]).flatten()
        if len(differ):
            parted[b] = int(differ[0])
    for t, (la, lb) in enumerate(zip(logp_a, logp_b)):
        live = [b for b in range(B) if parted.get(b, t + 1) > t]
        err = float((la[live] - lb[live]).abs().max()) if live else 0.0
        if not err < NEAR_TIE:
            fail(f"{what} step {t}: log-probs differ by {err}")
    for b, t in parted.items():
        gap = float(logp_a[t][b, ids_a[b, t]] - logp_a[t][b, ids_b[b, t]])
        print(f"{what} row {b}: the runs part at step {t}, log-prob gap "
              f"{gap:.3e} (near-tie limit {NEAR_TIE})")
        if gap >= NEAR_TIE:
            fail(f"{what} row {b} diverges at step {t} by {gap}")
    print(f"{what}: {B - len(parted)}/{B} rows identical over "
          f"{len(logp_a)} steps", flush=True)


def fused_attention_route(dev, card) -> dict:
    """Kernel #13 on the route: with E2E_ASR_FUSED_ATTN set (and then
    restored), a greedy decode and a per-step beam decode (beam 4) of 64
    utterances (120-512 frames) by the flagship (LSTM) and by the `-gru`
    flagship, random weights from seed 0, each beside the same decode
    without it. The fused runs launch #13 and not C, the unfused ones C
    and not #13; their outputs are equal up to near-ties; their host times
    side by side. Returns the launches of each run."""
    rng = np.random.default_rng(17)
    lens = rng.integers(120, 513, size=64)
    lens[0] = 512
    feats = rng.normal(size=(64, 512, 80)).astype(np.float32)
    feats[np.arange(512)[None, :] >= lens[:, None]] = 0.0
    batch = {"logmel": feats, "logmel_len": lens}
    saved = os.environ.pop("E2E_ASR_FUSED_ATTN", None)
    runs = {}
    try:
        for cells in ("lstm", "gru"):
            cfg = flagship_cfg(cells=cells)
            params = seq2seq.init(torch.Generator().manual_seed(0), cfg,
                                  device=dev)
            f = torch.tensor(feats, device=dev)
            n = torch.tensor(lens, device=dev)
            decode = beam_eval.make_beam_decoder(
                cfg, BeamConfig(beam_size=4, max_steps=120))
            kernels = ("lstm_bidir" if cells == "lstm" else "gru_bidir",
                       decode_rows(cells == "gru")[0])
            out, walls = {}, {}
            for fused in (False, True):
                if fused:
                    os.environ["E2E_ASR_FUSED_ATTN"] = "1"
                route = "#13" if fused else "unfused"
                step_row, off = (("attn_output_fused", "output_fused")
                                 if fused else
                                 ("output_fused", "attn_output_fused"))
                for kind, fn, extra in (
                        ("greedy", lambda: recorded_logp(
                            lambda: seq2seq.apply_greedy(params, cfg, f, n)),
                         ()),
                        ("beam 4", lambda: recorded_selections(
                            lambda: decode(params, batch)),
                         ("beam_select",))):
                    label = f"{cells} {kind} batch 64 {route}"
                    zero_launches()
                    t0 = time.monotonic()
                    with torch.no_grad():
                        out[kind, fused] = fn()
                    torch.cuda.synchronize()
                    walls[kind, fused] = time.monotonic() - t0
                    runs[label] = read_launches(label, kernels + (step_row,)
                                                + extra)
                    if runs[label][off]:
                        fail(f"the {label} run launched {off}")
            os.environ.pop("E2E_ASR_FUSED_ATTN", None)
            hold_greedy_runs(f"{cells} greedy unfused vs #13",
                             out["greedy", False], out["greedy", True])
            hold_beam_runs(f"{cells} beam unfused vs #13",
                           out["beam 4", False], out["beam 4", True],
                           cfg.decoders["char"].vocab_size)
            for kind in ("greedy", "beam 4"):
                print(f"{cells} {kind} batch 64 ({card}): unfused wall "
                      f"{walls[kind, False]:.3f} s, #13 wall "
                      f"{walls[kind, True]:.3f} s", flush=True)
    finally:
        os.environ.pop("E2E_ASR_FUSED_ATTN", None)
        if saved is not None:
            os.environ["E2E_ASR_FUSED_ATTN"] = saved
    return runs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1

    # 1. device
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("float32 throughout; TF32 off for matmuls and cuDNN")

    # 2. build
    t0 = time.monotonic()
    lib = build.build()
    build.library()
    print(f"built {lib.name} in {time.monotonic() - t0:.1f} s")
    for line in build.ptxas_report().splitlines():
        if any(s in line for s in ("entry function", "registers", "spill")):
            print("  " + line.strip())

    # 3. kernels
    cfg = flagship_cfg()
    params = seq2seq.init(torch.Generator().manual_seed(0), cfg, device=dev)
    print(f"flagship model: {seq2seq.param_count(params)} parameters")
    record = Recorder()
    with torch.no_grad():
        check_kernels(params, cfg, dev, record)
    check_train_kernels(params, cfg, dev, record)
    check_lm_kernels(params, cfg, dev, record)
    check_mega(params, cfg, dev, record)
    gru_cfg = flagship_cfg(40, PHONE_VOCAB, "gru")
    gru_params = seq2seq.init(torch.Generator().manual_seed(0), gru_cfg,
                              device=dev)
    check_gru_kernels(gru_params, gru_cfg, dev, record)
    check_dec_train_gru(gru_params, gru_cfg, dev, record)
    with torch.no_grad():
        check_cells_gru(gru_params, gru_cfg, dev, record)
        check_attn_output(params, cfg, gru_params, gru_cfg, dev, record)
    check_mega(gru_params, gru_cfg, dev, record, "beam_mega_gru")
    del gru_params

    # 4. serving
    rev_vocab = START_VOCAB + ["<sp>"] + [chr(ord("a") + i)
                                          for i in range(26)]
    rev_vocab += [f"#{i}" for i in range(40 - len(rev_vocab))]
    with torch.no_grad():
        zero_launches()
        feats, texts, stats = serve(params, cfg, dev, rev_vocab)
        paths = {"serving": read_launches("serving", SERVING_PATH)}
        print(f"serving ({card}): {json.dumps(stats)}")
        print(f"first transcripts: {[t[:60] for t in texts[:3]]}")
        if len(texts) != 24 or not all(isinstance(t, str) for t in texts):
            fail("not every request got a transcript")
        compare_cpu(params, cfg, feats)

    # 5. training: the ASR step, then the LM step and the phone multitask
    paths["asr"] = train(cfg, dev, card)
    paths["lm_multitask"] = train_lm_multitask(dev, card)

    # 6. recipe
    paths.update(recipe(dev, card))

    # 7. entry points
    paths.update(entry_points(dev, card))

    # 8. the GRU family (-gru): its train step; the Trainer (train, greedy
    # dev WER, save, resume) and beam evaluation at batches of 1 and 64;
    # serving and card-vs-CPU decodes
    paths["gru"] = train_gru(dev, card)
    paths.update(recipe(dev, card, "gru"))
    paths["serving gru"] = serve_cells(dev, card, rev_vocab, "gru")

    # 9. a GRU encoder under the LSTM decoders: Trainer (train, greedy dev
    # WER, save, resume), beam evaluation at a batch of 1, serving
    paths.update(recipe(dev, card, "gru_encoder"))
    paths["serving gru_encoder"] = serve_cells(dev, card, rev_vocab,
                                               "gru_encoder")

    # 10. kernel #13 on the route (E2E_ASR_FUSED_ATTN), LSTM and GRU
    paths.update(fused_attention_route(dev, card))
    for row in record.rows:
        row["launches"] = sum(p[row["name"]] for p in paths.values())
    print(json.dumps({"kernels": record.rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
