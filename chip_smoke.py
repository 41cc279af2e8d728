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
   launched.
Each main-path run (serving, ASR training, LM + multitask, recipe) counts
its kernels' launches from zero; a row's `launches` in the kernels line is
their sum over those runs. The line before the last is a JSON object with
the per-kernel numbers; the last line is {"ok": true, "device": {...}}.
float32 throughout, TF32 off.
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
from e2e_asr_tpu_torch.data.text import EOS_ID, GO_ID, START_VOCAB
from e2e_asr_tpu_torch.eval import beam_eval
from e2e_asr_tpu_torch.eval.serving import BatchingTranscriber
from e2e_asr_tpu_torch.kernels import (beam_select, build, dec_step,
                                       dec_train, lstm_bidir, lstm_seq)
from e2e_asr_tpu_torch.models import attn_decoder, encoder, seq2seq
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
       "lstm_bwd_lm": 1e-4}
RELATIVE = {"lstm_bidir_bwd", "lstm_bwd", "dec_train_bwd", "lstm_bwd_lm"}
NEAR_TIE = 1e-3
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12   # H100 SXM: f32 (no tensor cores)
TRAIN_B, TRAIN_T, TRAIN_L = 128, 384, 48  # the bench's train shape
LM_B, LM_T = 128, 120     # lm_batch_size; input steps (the char max_output)
PHONE_VOCAB = 46          # data/synth.py's phone vocabulary


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


def flagship_cfg(char_vocab: int = 40, phone_vocab: int | None = None):
    """The flagship model; with phone_vocab, the recipe's char + phone
    multitask (a phone decoder of the same widths on encoder layer 3, the
    `-nlp` default)."""
    def dec(vocab, max_output):
        return DecoderConfig(hidden_size_dec=256, emb_size=256,
                             vocab_size=vocab, lm_hidden_size=256,
                             attention_vec_size=128, max_output=max_output)

    tasks, layers, out = ["char"], {"char": 4}, {"char": 120}
    decoders = {"char": dec(char_vocab, 120)}
    if phone_vocab is not None:
        tasks.append("phone")
        layers["phone"], out["phone"] = 3, 250
        decoders["phone"] = dec(phone_vocab, 250)
    return Seq2SeqConfig(
        tasks=tasks, num_layers=layers, max_output=out,
        encoder=EncoderConfig(hidden_size=256, skip_step=2,
                              max_scaling_down=8),
        decoders=decoders, avg=True, feat_length=80)


class Recorder:
    """Holds each kernel to its plain version and keeps its JSON row."""

    def __init__(self):
        self.rows = []

    def __call__(self, name, source, replaces, got, want, fn, ref, n, n_ref,
                 work, library=None):
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
        ms, plain_ms = time_ms(fn, n), time_ms(ref, n_ref, warmup=1)
        bound_ms, bound_by = bound(*work)
        library_ms = None if library is None else library()
        lib = "none" if library_ms is None else f"{library_ms:.4f}"
        kind = "relative" if name in RELATIVE else "absolute"
        print(f"kernel {name}: max_abs_err={abs_err:.3e} "
              f"max_rel_err={rel_err:.3e} tolerance={TOL[name]:.0e} "
              f"({kind}) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bound_ms:.4f} ({bound_by}) library_ms={lib}",
              flush=True)
        if not ok:
            fail(f"{name} disagrees with its plain version: {abs_err} "
                 f"(relative {rel_err})")
        self.rows.append({"name": name, "route": "cuda", "source": source,
                          "replaces": replaces, "max_abs_err": abs_err,
                          "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": library_ms})


def cudnn_lstm_ms(x, lens, H, bidirectional, backward) -> float:
    """cuDNN's nn.LSTM on the packed batch (same input width, hidden size
    and lengths): its training forward, or its backward as the time of
    forward + backward less the forward's. Timed only, as a yardstick."""
    lstm = torch.nn.LSTM(x.shape[-1], H, bidirectional=bidirectional).to(
        x.device)
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
    plain_tokens = dec_train.sampled_tokens(free, gum_sh)
    differ = (kernel_tokens != plain_tokens) & (flag_sh > 0)
    for b in range(B):
        steps = torch.nonzero(differ[:, b]).flatten()
        if len(steps):     # later steps of this row follow the first part
            t = int(steps[0])
            z = free[t - 1, b] + gum_sh[t, b]
            gap = float(z[plain_tokens[t, b]] - z[kernel_tokens[t, b]])
            print(f"dec_train row {b}: sampled tokens part at step {t}, "
                  f"gap {gap:.3e} (near-tie limit {NEAR_TIE})")
            if gap >= NEAR_TIE:
                fail(f"dec_train row {b} samples another token at step "
                     f"{t}: gap {gap}")
    print(f"dec_train: {int((flag_sh[:, 0] > 0).sum())} sampled steps, "
          f"{int(differ.any(0).sum())} rows part at a near-tie", flush=True)

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
    select = beam_select.beam_select

    def recording(steps):
        def wrapped(*args, **kw):
            out = select(*args, **kw)
            steps.append({k: v.cpu() for k, v in out.items()})
            return out
        return wrapped

    runs = {}
    try:
        for name, p in (("cuda", params), ("cpu", to_device(params, "cpu"))):
            steps = []
            beam_select.beam_select = recording(steps)
            t0 = time.monotonic()
            out = [t.cpu() for t in decode(p, batch)]
            runs[name] = (out, steps)
            print(f"decode on {name}: {len(steps)} steps, "
                  f"{time.monotonic() - t0:.3f} s", flush=True)
    finally:
        beam_select.beam_select = select
    (tok_g, len_g, sc_g), steps_g = runs["cuda"]
    (tok_c, len_c, sc_c), steps_c = runs["cpu"]
    for name, t in (("tokens", tok_g), ("scores", sc_g)):
        if not torch.isfinite(t.float()).all():
            fail(f"non-finite {name} from the card")
    if tok_g.shape != (8, 120) or not ((tok_g >= 0) & (tok_g < 40)).all():
        fail(f"bad token array {tuple(tok_g.shape)}")
    for b in range(8):
        part = None
        for s, (g, c) in enumerate(zip(steps_g, steps_c)):
            if not all(torch.equal(g[k][b], c[k][b]) for k in
                       ("parent", "token", "order", "fin_dest")):
                part = s
                break
            if (g["vals"][b] - c["vals"][b]).abs().max() > NEAR_TIE:
                fail(f"row {b} step {s}: selection scores differ by more "
                     f"than {NEAR_TIE} before any divergence")
        if part is None:
            if not (torch.equal(tok_g[b], tok_c[b])
                    and int(len_g[b]) == int(len_c[b])):
                fail(f"row {b}: same selections but different outputs")
            continue
        g, c = steps_g[part], steps_c[part]
        r = next(r for r in range(g["parent"].shape[1])
                 if (g["parent"][b, r], g["token"][b, r])
                 != (c["parent"][b, r], c["token"][b, r]))
        gap = float((g["vals"][b, r] - c["vals"][b, r]).abs())
        print(f"row {b}: cuda and cpu part at step {part} rank {r}, "
              f"selection-score gap {gap:.3e} (near-tie limit {NEAR_TIE})")
        if gap >= NEAR_TIE:
            fail(f"row {b} diverges at step {part} by {gap}")
    same = int(sum(torch.equal(tok_g[b], tok_c[b]) for b in range(8)))
    print(f"cuda vs cpu: {same}/8 rows identical; max score diff "
          f"{float((sc_g - sc_c).abs().max()):.3e}", flush=True)


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
            "lstm_bwd_lm": (lstm_bidir, "BWD_SINGLE_LAUNCHES")}
# The kernels each main path must launch. The ASR step takes both
# directions of A's backward in one launch (lstm_bidir_bwd), never
# lstm_bwd; the LM step's kernel #3 has no mask, and its backward is #5.
SERVING_PATH = ("lstm_bidir", "cells_fused", "output_fused", "beam_select")
TRAIN_PATH = ("lstm_bidir_train", "lstm_bidir_bwd", "dec_train_fwd",
              "dec_train_bwd")
LM_PATH = ("lstm_seq_train", "lstm_bwd")
RECIPE_PATH = TRAIN_PATH + LM_PATH + ("lstm_bidir", "cells_fused",
                                      "output_fused")


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
    dcfg = dataclasses.replace(cfg.decoders["char"], samp_prob=0.0)
    cfg = dataclasses.replace(cfg, decoders={"char": dcfg})
    B = 16
    batch = train_batch(np.random.default_rng(5), B, cfg)
    gen = torch.Generator().manual_seed(5)
    params = seq2seq.init(gen, cfg, device="cpu")
    masks, t = {}, TRAIN_T
    for i, reduce in enumerate(encoder.layer_plan(cfg.encoder, 4)):
        masks[i + 1] = dropout_mask(gen, (t, B, 2 * cfg.encoder.hidden_size),
                                    cfg.encoder.out_prob, "cpu")
        t = -(-t // cfg.encoder.skip_step) if reduce else t
    noise = {"encoder": masks, "char": attn_decoder.train_noise(
        gen, dcfg, TRAIN_L - 1, B, "cpu")}
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


def train(cfg, dev, card: str) -> dict:
    """Phase 5: (a) card vs CPU at B=16, (b) three steps at the bench's
    train shape, (c) their time. Returns the launches of the training
    kernels in (b) alone."""
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
    launches = read_launches("ASR training", TRAIN_PATH)
    if not all(np.isfinite(losses)) or int(state.global_step) != 3:
        fail(f"training losses {losses}, global_step "
             f"{int(state.global_step)}")
    frames = int(batch["logmel_len"].sum())
    steady = float(np.mean(times[1:]))
    print(f"training B={TRAIN_B} T={TRAIN_T} L={TRAIN_L} ({card}): losses "
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


def recipe(dev, card) -> dict:
    """Phase 6: train a synthetic corpus at the flagship shape with the
    port's Trainer, evaluate, save, and resume in a second Trainer.
    Returns the launches of the training run."""
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
            best_model_dir=os.path.join(root, "best"), lm_prob=0.5,
            steps_per_checkpoint=3, compute_dtype="float32")
        cfg = ExperimentConfig(
            model=flagship_cfg(sizes["char"], sizes["phone"]),
            train=train_cfg, lm=LMConfig(vocab_size=sizes["char"]))
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
        launches = read_launches("recipe", RECIPE_PATH)
        asr = [float(x) for x in losses["asr"]]
        lm = [float(x) for x in losses["lm"]]
        with open(os.path.join(train_cfg.train_dir, "asr_err.txt")) as f:
            errs = [float(x) for x in f.read().split()]
        print(f"recipe ({card}): {int(state.global_step)} ASR steps, "
              f"{int(state.lm_global_step)} LM steps, "
              f"{int(state.lm_epoch)} LM epochs; ASR losses "
              f"{[round(x, 4) for x in asr]}; LM losses "
              f"{[round(x, 4) for x in lm]}; dev WER {errs}; wall "
              f"{wall:.1f} s", flush=True)
        if not (asr and lm and np.isfinite(asr + lm).all()):
            fail(f"recipe losses: ASR {asr}, LM {lm}")
        found = checkpoint.restore_latest(train_cfg.train_dir)
        if found is None or len(errs) != 2 or int(state.global_step) != 6:
            fail(f"recipe: {len(errs)} dev evaluations, global step "
                 f"{int(state.global_step)}, checkpoint {found is not None}")
        named = found[0]
        second = Trainer(dataclasses.replace(cfg, train=dataclasses.replace(
            train_cfg, max_epochs=0)), device=dev)
        resumed = step.state_to_named(second.train())
        if not (resumed.keys() == named.keys() and all(
                np.array_equal(resumed[k], v) for k, v in named.items())):
            fail("the second Trainer did not resume the saved state")
        print(f"recipe: checkpoint of step {int(named['global_step'])} "
              f"written and resumed by a second Trainer ({len(named)} "
              f"leaves equal)", flush=True)
    return launches


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
    paths["recipe"] = recipe(dev, card)
    for row in record.rows:
        row["launches"] = sum(p[row["name"]] for p in paths.values())
    print(json.dumps({"kernels": record.rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
