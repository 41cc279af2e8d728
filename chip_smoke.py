#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (e2e_asr_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases; any failure exits nonzero and prints no result line:
1. device: requires CUDA; prints the card's name and power limit
   (nvidia-smi) and the torch / CUDA versions;
2. build: compiles the kernels from csrc/ with nvcc and prints ptxas's
   register / shared-memory / spill lines;
3. kernels: each of the four kernels against its plain PyTorch version on
   the same CUDA inputs at the serving slice's shapes, with the error, the
   stated tolerance and CUDA-event times of both;
4. slice: the flagship model (4-layer pyramidal BiLSTM, H=256, feat 80;
   1-layer LSTM attention decoder, V=40; random weights from seed 0)
   serves 24 requests through BatchingTranscriber (max_batch 8, beam 4,
   buckets 128/256/512); every kernel's launch count must be > 0; one batch
   decoded on the card must equal the same batch decoded by the plain path
   on the CPU, up to near-ties (< 1e-3) in the step where they part.
The line before the last is a JSON object with the per-kernel numbers; the
last line is {"ok": true, "device": {...}}. float32 throughout, TF32 off.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from e2e_asr_tpu_torch.core import cells
from e2e_asr_tpu_torch.core.checkpoint import to_device
from e2e_asr_tpu_torch.eval import beam_eval
from e2e_asr_tpu_torch.eval.serving import BatchingTranscriber
from e2e_asr_tpu_torch.kernels import beam_select, build, dec_step, lstm_bidir
from e2e_asr_tpu_torch.models import seq2seq
from e2e_asr_tpu_torch.shared import (START_VOCAB, BeamConfig, DecoderConfig,
                                      EncoderConfig, Seq2SeqConfig)

TOL = {"lstm_bidir": 1e-4, "cells_fused": 1e-4, "output_fused": 1e-4,
       "beam_select": 0.0}
NEAR_TIE = 1e-3


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


def flagship_cfg():
    return Seq2SeqConfig(
        tasks=["char"], num_layers={"char": 4}, max_output={"char": 120},
        encoder=EncoderConfig(hidden_size=256, skip_step=2,
                              max_scaling_down=8),
        decoders={"char": DecoderConfig(
            hidden_size_dec=256, emb_size=256, vocab_size=40,
            lm_hidden_size=256, attention_vec_size=128, max_output=120)},
        feat_length=80)


def check_kernels(params, cfg, dev) -> list[dict]:
    """Phase 3: every kernel against its plain version at the slice's
    shapes (A: T=512, B=8, H=256; B, C: N=32 rows; D: B=8, k=4, V=40)."""
    rng = np.random.default_rng(1)
    rand = lambda *s, scale=1.0: torch.tensor(  # noqa: E731
        rng.normal(size=s).astype(np.float32) * scale, device=dev)
    dec = params["decoder_char"]
    dcfg = cfg.decoders["char"]
    results = []

    def record(name, route_src, replaces, got, want, fn, ref, n, n_ref):
        abs_err, rel_err = max_err(got, want)
        ms, plain_ms = time_ms(fn, n), time_ms(ref, n_ref)
        print(f"kernel {name}: max_abs_err={abs_err:.3e} "
              f"max_rel_err={rel_err:.3e} tolerance={TOL[name]:.0e} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}", flush=True)
        if not abs_err <= TOL[name]:
            fail(f"{name} disagrees with its plain version: {abs_err}")
        results.append({"name": name, "route": "cuda", "source": route_src,
                        "replaces": replaces, "max_abs_err": abs_err,
                        "ms": ms, "plain_ms": plain_ms})

    # A: encoder layer 1 of the flagship on random log-mel features.
    T, B = 512, 8
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
    record("lstm_bidir", "e2e_asr_tpu_torch/csrc/lstm_bidir.cu",
           "e2e_asr_tpu/ops/lstm_pallas.py:638",
           lstm_bidir.lstm_seq_bidir(*a_args),
           lstm_bidir.lstm_seq_bidir_reference(*a_args),
           lambda: lstm_bidir.lstm_seq_bidir(*a_args),
           lambda: lstm_bidir.lstm_seq_bidir_reference(*a_args), 20, 2)

    # B and C: one decode step over N = 8 rows x 4 beams.
    N, H, Henc = 32, dcfg.hidden_size_dec, 2 * cfg.encoder.hidden_size
    tokens = torch.tensor(rng.integers(0, dcfg.vocab_size, size=N),
                          device=dev)
    state = lambda w: cells.LSTMState(rand(N, w, scale=0.5),  # noqa: E731
                                      rand(N, w, scale=0.5))
    b_args = (dec, dec["embedding"][tokens], rand(N, Henc, scale=0.3),
              state(dcfg.lm_hidden_size),
              tuple(state(H) for _ in range(dcfg.num_layers_dec)))
    flat = lambda out: [out[0].c, out[0].h, out[2]] + [  # noqa: E731
        t for s in out[1] for t in s]
    record("cells_fused", "e2e_asr_tpu_torch/csrc/dec_step.cu",
           "e2e_asr_tpu/ops/dec_step_pallas.py:162",
           flat(dec_step.cells_fused(*b_args)),
           flat(dec_step.cells_fused_reference(*b_args)),
           lambda: dec_step.cells_fused(*b_args),
           lambda: dec_step.cells_fused_reference(*b_args), 200, 50)
    c_args = (dec, dcfg, rand(N, H, scale=0.5), rand(N, Henc, scale=0.3))
    record("output_fused", "e2e_asr_tpu_torch/csrc/dec_step.cu",
           "e2e_asr_tpu/ops/dec_step_pallas.py:336",
           [dec_step.output_fused(*c_args)],
           [dec_step.output_fused_reference(*c_args)],
           lambda: dec_step.output_fused(*c_args),
           lambda: dec_step.output_fused_reference(*c_args), 200, 50)

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
           "e2e_asr_tpu/ops/beam_select_pallas.py:129",
           [got[key].float() for key in want],
           [want[key].float() for key in want],
           lambda: beam_select.beam_select(*d_args),
           lambda: beam_select.beam_select_reference(*d_args), 200, 50)
    return results


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

    with torch.no_grad():
        # 3. kernels
        cfg = flagship_cfg()
        params = seq2seq.init(torch.Generator().manual_seed(0), cfg,
                              device=dev)
        print(f"flagship model: {seq2seq.param_count(params)} parameters")
        kernels = check_kernels(params, cfg, dev)

        # 4. slice
        rev_vocab = START_VOCAB + ["<sp>"] + [chr(ord("a") + i)
                                              for i in range(26)]
        rev_vocab += [f"#{i}" for i in range(40 - len(rev_vocab))]
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
        for entry in kernels:
            entry["launches"] = launches[entry["name"]]
        compare_cpu(params, cfg, feats)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
