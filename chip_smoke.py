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
   step time and frames/s.
The line before the last is a JSON object with the per-kernel numbers; the
last line is {"ok": true, "device": {...}}. float32 throughout, TF32 off.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from e2e_asr_tpu_torch.config import (BeamConfig, DecoderConfig,
                                      EncoderConfig, LMConfig, Seq2SeqConfig)
from e2e_asr_tpu_torch.core import cells
from e2e_asr_tpu_torch.core.checkpoint import named_from_params, to_device
from e2e_asr_tpu_torch.core.layers import dropout_mask
from e2e_asr_tpu_torch.data.text import EOS_ID, GO_ID, START_VOCAB
from e2e_asr_tpu_torch.eval import beam_eval
from e2e_asr_tpu_torch.eval.serving import BatchingTranscriber
from e2e_asr_tpu_torch.kernels import (beam_select, build, dec_step,
                                       dec_train, lstm_bidir)
from e2e_asr_tpu_torch.models import attn_decoder, encoder, seq2seq
from e2e_asr_tpu_torch.train import step

# Tolerances against the plain version on the card: forward values of order
# 1 take 1e-4 absolute (float32 sums in another order); gradients, whose
# sums run over up to T*B = 49152 rows, 1e-4 relative to each output's
# largest value; the selection is exact.
TOL = {"lstm_bidir": 1e-4, "cells_fused": 1e-4, "output_fused": 1e-4,
       "beam_select": 0.0, "lstm_bidir_train": 1e-4, "lstm_bidir_bwd": 1e-4,
       "lstm_bwd": 1e-4, "dec_train_fwd": 1e-4, "dec_train_bwd": 1e-4}
RELATIVE = {"lstm_bidir_bwd", "lstm_bwd", "dec_train_bwd"}
NEAR_TIE = 1e-3
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12   # H100 SXM: f32 (no tensor cores)
TRAIN_B, TRAIN_T, TRAIN_L = 128, 384, 48  # the bench's train shape


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


def flagship_cfg():
    return Seq2SeqConfig(
        tasks=["char"], num_layers={"char": 4}, max_output={"char": 120},
        encoder=EncoderConfig(hidden_size=256, skip_step=2,
                              max_scaling_down=8),
        decoders={"char": DecoderConfig(
            hidden_size_dec=256, emb_size=256, vocab_size=40,
            lm_hidden_size=256, attention_vec_size=128, max_output=120)},
        feat_length=80)


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


TRAIN_KERNELS = {"lstm_bidir_train": ("lstm_bidir", "TRAIN_LAUNCHES"),
                 "lstm_bidir_bwd": ("lstm_bidir", "BWD_LAUNCHES"),
                 "lstm_bwd": ("lstm_bidir", "BWD_SINGLE_LAUNCHES"),
                 "dec_train_fwd": ("dec_train", "FWD_LAUNCHES"),
                 "dec_train_bwd": ("dec_train", "BWD_LAUNCHES")}
# lstm_bwd, the single-direction entry of A's backward (#5's function), is
# held to its plain version in phase 3; the training path takes both
# directions in one launch (lstm_bidir_bwd) and never calls it.
TRAIN_PATH = ("lstm_bidir_train", "lstm_bidir_bwd", "dec_train_fwd",
              "dec_train_bwd")
MODULES = {"lstm_bidir": lstm_bidir, "dec_train": dec_train}


def train_batch(rng, B: int, cfg) -> dict:
    """B utterances of up to TRAIN_T frames with transcripts of up to
    TRAIN_L - 1 characters (ending in <eos>), random from `rng`."""
    T, L, V = TRAIN_T, TRAIN_L, cfg.decoders["char"].vocab_size
    lens = rng.integers(T // 2, T + 1, size=B)
    lens[0] = T
    char_len = rng.integers(L // 2, L, size=B)
    char_len[0] = L - 1
    char = np.zeros((B, L), np.int64)
    char[:, 0] = GO_ID
    for i, n in enumerate(char_len):
        char[i, 1:n] = rng.integers(3, V, size=n - 1)
        char[i, n] = EOS_ID
    feats = rng.normal(size=(B, T, cfg.feat_length)).astype(np.float32)
    feats[np.arange(T)[None, :] >= lens[:, None]] = 0.0
    return {"logmel": feats, "logmel_len": lens, "char": char,
            "char_len": char_len}


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
    runs = {}
    for where in ("cpu", dev):
        asr_step, _ = step.make_train_step(cfg, lm_cfg, device=where)
        state = step.create_state(params, cfg, lm_cfg, device=where)
        t0 = time.monotonic()
        loss, _, grads = asr_step.loss_and_grads(state.params, batch, None,
                                                 noise)
        new_state, _ = asr_step(state, batch, None, noise)
        runs[str(where)] = (float(loss), named_from_params(grads),
                            named_from_params(new_state.params))
        print(f"asr_step B={B} on {where}: loss {float(loss):.6f}, "
              f"{time.monotonic() - t0:.2f} s", flush=True)
    (loss_c, g_c, p_c), (loss_g, g_g, p_g) = runs["cpu"], runs[str(dev)]
    # Tolerances: loss 1e-5 relative; gradients 1e-3 relative to each
    # leaf's largest value (sums over 384-step recurrences in other
    # orders); params 1e-5 (1% of one Adam step at lr 1e-3) where |g| is
    # above 1% of its leaf's largest.
    if not abs(loss_g - loss_c) <= 1e-5 * abs(loss_c):
        fail(f"loss on the card {loss_g} vs the CPU {loss_c}")
    worst_g = worst_p = 0.0
    for name, w in g_c.items():
        scale = max(float(np.abs(w).max()), 1e-12)
        worst_g = max(worst_g, float(np.abs(g_g[name] - w).max()) / scale)
        big = np.abs(w) > 1e-2 * scale
        if big.any():
            worst_p = max(worst_p, float(np.abs(p_g[name][big]
                                                - p_c[name][big]).max()))
    print(f"card vs CPU at B={B}: loss {loss_g:.6f} vs {loss_c:.6f}; "
          f"gradients max error {worst_g:.3e} of each leaf's largest "
          f"(tolerance 1e-3); params after the step max error "
          f"{worst_p:.3e} (tolerance 1e-5)", flush=True)
    if not (worst_g <= 1e-3 and worst_p <= 1e-5):
        fail("the card's asr_step disagrees with the CPU's")


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
    for module, counter in TRAIN_KERNELS.values():
        setattr(MODULES[module], counter, 0)
    times, losses = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = asr_step(state, batch, gen)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {name: getattr(MODULES[m], c)
                for name, (m, c) in TRAIN_KERNELS.items()}
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
    print(f"launches in the training run: {json.dumps(launches)}")
    for name in TRAIN_PATH:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the training path")
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

    # 4. serving
    rev_vocab = START_VOCAB + ["<sp>"] + [chr(ord("a") + i)
                                          for i in range(26)]
    rev_vocab += [f"#{i}" for i in range(40 - len(rev_vocab))]
    with torch.no_grad():
        lstm_bidir.LAUNCHES = 0
        dec_step.CELLS_LAUNCHES = dec_step.OUTPUT_LAUNCHES = 0
        beam_select.LAUNCHES = 0
        feats, texts, stats = serve(params, cfg, dev, rev_vocab)
        launches = {"lstm_bidir": lstm_bidir.LAUNCHES,
                    "cells_fused": dec_step.CELLS_LAUNCHES,
                    "output_fused": dec_step.OUTPUT_LAUNCHES,
                    "beam_select": beam_select.LAUNCHES}
        print(f"serving ({card}): {json.dumps(stats)}")
        print(f"launches in the serving run: {json.dumps(launches)}")
        print(f"first transcripts: {[t[:60] for t in texts[:3]]}")
        if len(texts) != 24 or not all(isinstance(t, str) for t in texts):
            fail("not every request got a transcript")
        for name, n in launches.items():
            if n <= 0:
                fail(f"kernel {name} was not launched by the serving path")
        compare_cpu(params, cfg, feats)

    # 5. training
    launches.update(train(cfg, dev, card))
    for row in record.rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": record.rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
