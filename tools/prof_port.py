#!/usr/bin/env python3
"""Device-time profile of the PyTorch/CUDA port's serving path on one GPU.

    python3 tools/prof_port.py [--out FILE.json]

Uses the flagship model of chip_smoke.py (random weights from seed 0) and
measures, float32 with TF32 off (the training kernels' isolated times are
chip_smoke.py's):

1. each kernel at the serving shapes (A: T=512/256/128/64, B=8, H=256;
   B, C: N=32 rows; D: B=8, k=4, V=40; #18: B=8, T'=64, nh 4, hd 128),
   beside its plain PyTorch version:
   - `device_us`: device time per call, the summed durations of the
     call's kernels, memcpys and memsets in a torch.profiler trace;
   - `event_ms`: CUDA-event time per call of back-to-back eager calls
     (chip_smoke.time_ms), which includes host time when the host is
     slower than the device;
   - `graph_ms` (plain version only): CUDA-event time per call when the
     calls are replayed from one captured CUDA graph, i.e. without the
     host's launch cost;
   - for #18, `library_device_us` and `library_event_ms`: the same two
     for scaled_dot_product_attention on the same out;
2. one batch of 8 through the beam decoder per bucket (128/256/512 frames,
   beam 4, 120 steps): `wall_ms` on the host clock around the decode and a
   device sync; `busy_ms`, the union of the intervals of all device
   activity in its trace (overlaps counted once); `busy_share` =
   busy_ms / wall_ms; and the encoder's wall alone; then one 512-frame
   utterance at beam 4: the whole decode (kernel #15's route at B=1) and
   the search alone by either route, #15 or the per-step kernels;
3. one asr_step of the flagship at the bench's train shape (B=128, T=384,
   L=48; after two warm-up steps): its wall, device busy share, and the
   device time and launches of each kernel in its trace, the port's own
   kernels by name and PyTorch's summed as "torch_matmul" (the matmuls
   outside the kernels: input projections, the joint's, the weight
   gradients), "torch_softmax" (log-softmax forward and backward) and
   "other" (the elementwise work, the optimizer); the same for one
   asr_step of the char + phone model (phone decoder on encoder layer 3),
   for one lm_step at B=128, T=120 (chip_smoke.lm_batch), for one asr_step
   of the GRU family's char + phone model (`-gru`) and for one asr_step of
   the flagship transducer (`-model_family transducer`: the encoder's A
   and its backward, #3 and #5 in the prediction network, the joint in
   PyTorch, kernel #17 both ways; the backward chain kernel is split into
   A's two-direction launches and #5's one-direction ones), and the
   transducer's joint alone, forward and backward, at the step's shapes;
   then one asr_step of the hybrid CTC/attention model (`-ctc_weight
   0.3`, char + phone) and of the CTC family (`-model_family ctc`), and
   the hybrid's decode of a batch of 8 512-frame utterances by joint
   CTC/attention beams (kernel #16 every step) and by its plain beam;
   then one asr_step of the deep decoders' char + phone model
   (chip_smoke.deep_cfg: a two-layer char decoder, 1280-wide LM cells
   through SimpleProjection, ind_softmax; #8/#9's deep branches) and its
   lm_step at H=1280 (#4's training form and #5's wide form); then one
   asr_step of the transformer encoder family (chip_smoke.transformer_cfg:
   4 blocks at d_model 512 under the char + phone LSTM decoders), its
   attention chain (the plain matmul chain of each block's self-attention,
   forward and backward; kernel #18 runs in inference only) split from
   the other matmuls as "attention_chain";
4. the GRU decode of the `-gru` flagship (random weights from seed 0) on
   the encoder output of 512-frame utterances: one beam search (beam 4,
   120 steps) of a batch of 8 by the per-step route (#11's GRU branch, the
   attention, #12, #14) and one of a single utterance by #15's GRU
   branch: the same wall, device busy share and per-kernel split.

Traces are written under build/e2e_asr_tpu_torch/prof/. Prints one line per
measurement, the card's name and power limit first, and the JSON of all
numbers last (also to --out if given).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from e2e_asr_tpu_torch.core import cells  # noqa: E402
from e2e_asr_tpu_torch.eval import beam, beam_eval  # noqa: E402
from e2e_asr_tpu_torch.kernels import (beam_select, build,  # noqa: E402
                                       dec_step, lstm_bidir, mhsa)
from e2e_asr_tpu_torch.models import seq2seq, transducer  # noqa: E402
from e2e_asr_tpu_torch.train import step  # noqa: E402
from e2e_asr_tpu_torch.config import BeamConfig, LMConfig  # noqa: E402

TRACE_DIR = ROOT / "build" / "e2e_asr_tpu_torch" / "prof"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_events(fn, n: int, name: str, keep_all: bool = False
                  ) -> list[dict]:
    """Run fn() n times under the profiler; the trace's device events (or
    every event of the trace with keep_all)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / f"{name}.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return events if keep_all else [e for e in events
                                    if e.get("cat") in DEVICE_CATS]


def busy_us(events: list[dict]) -> float:
    """Length of the union of the events' [ts, ts + dur) intervals."""
    total, end = 0.0, -float("inf")
    for start, stop in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def graph_ms(fn, n: int) -> float:
    """Per-call time of n calls of fn replayed from one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def kernel_cases(params, cfg, dev) -> dict:
    """name -> (kernel call, plain call, CUDA kernel name, calls to time,
    one PyTorch call of the same function or None)."""
    rng = np.random.default_rng(1)

    def rand(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape).astype(np.float32)
                            * scale, device=dev)

    cases = {}
    layer = params["encoder"]["layer_1"]
    w_fw = layer["fw"]["kernel"][cfg.feat_length:]
    w_bw = layer["bw"]["kernel"][cfg.feat_length:]
    for T in (512, 256, 128, 64):
        args = (rand(T, 8, w_fw.shape[1]), rand(T, 8, w_fw.shape[1]), w_fw,
                w_bw, torch.ones(T, 8, 1, device=dev))
        cases[f"lstm_bidir_T{T}"] = (
            lambda a=args: lstm_bidir.lstm_seq_bidir(*a),
            lambda a=args: lstm_bidir.lstm_seq_bidir_reference(*a),
            "lstm_bidir_fwd_kernel", 3, None)
    dec, dcfg = params["decoder_char"], cfg.decoders["char"]
    N, H, Henc = 32, dcfg.hidden_size_dec, 2 * cfg.encoder.hidden_size

    def state(width):
        return cells.LSTMState(rand(N, width, scale=0.5),
                               rand(N, width, scale=0.5))

    tokens = torch.tensor(rng.integers(0, dcfg.vocab_size, size=N),
                          device=dev)
    b_args = (dec, dec["embedding"][tokens], rand(N, Henc, scale=0.3),
              state(dcfg.lm_hidden_size),
              tuple(state(H) for _ in range(dcfg.num_layers_dec)))
    cases["cells_fused"] = (lambda: dec_step.cells_fused(*b_args),
                            lambda: dec_step.cells_fused_reference(*b_args),
                            "cells_fused_kernel", 50, None)
    c_args = (dec, dcfg, rand(N, H, scale=0.5), rand(N, Henc, scale=0.3))
    cases["output_fused"] = (lambda: dec_step.output_fused(*c_args),
                             lambda: dec_step.output_fused_reference(*c_args),
                             "output_fused_kernel", 50, None)
    d_args = (-torch.rand(8, 4, device=dev) * 20,
              torch.log_softmax(rand(8, 4, dcfg.vocab_size, scale=3.0), -1),
              torch.ones(8, 4, dtype=torch.bool, device=dev),
              torch.zeros(8, dtype=torch.int32, device=dev))
    cases["beam_select"] = (
        lambda: beam_select.beam_select(*d_args),
        lambda: beam_select.beam_select_reference(*d_args),
        "beam_select_kernel", 50, None)
    # #18 at the burst's largest bucket (T' = 64, B = 8, nh 4, hd 128);
    # the library call is scaled_dot_product_attention with the padding
    # bias as its additive mask (out alone, not the probs).
    lens = np.array([64, 60, 51, 40, 33, 20, 9, 1])
    pad = torch.tensor(np.where(np.arange(64)[None, :] < lens[:, None], 0.0,
                                -1e30).astype(np.float32), device=dev)
    m_args = (rand(8, 4, 64, 128), rand(8, 4, 64, 128), rand(8, 4, 64, 128),
              pad, torch.zeros(4, 64, 64, device=dev))
    mask = (m_args[4][None] + pad[:, None, None, :]).contiguous()
    cases["mhsa"] = (lambda: mhsa.attend(*m_args, return_probs=True),
                     lambda: mhsa.attend_reference(*m_args),
                     "mhsa_fwd_kernel", 50,
                     lambda: torch.nn.functional.scaled_dot_product_attention(
                         *m_args[:3], attn_mask=mask))
    return cases


def profile_kernels(params, cfg, dev) -> dict:
    out = {}
    for name, (kernel, plain, cuda_name, n, library) in kernel_cases(
            params, cfg, dev).items():
        # A profiling session now and then comes back without the kernel's
        # records (seen once at T=256 after a clean T=512 session): take
        # up to three sessions before giving up.
        for attempt in range(3):
            ev_k = device_events(kernel, n, f"{name}_kernel")
            mine = [e for e in ev_k if cuda_name in e["name"]]
            if mine:
                break
            print(f"{name}: no {cuda_name} in trace {attempt + 1} "
                  f"({len(ev_k)} device events); profiling again", flush=True)
        else:
            raise RuntimeError(f"{name}: no {cuda_name} in three traces")
        ev_p = device_events(plain, n, f"{name}_plain")
        row = {"device_us": sum(e["dur"] for e in mine) / n,
               "plain_device_us": sum(e["dur"] for e in ev_p) / n,
               "event_ms": chip_smoke.time_ms(kernel, n),
               "plain_event_ms": chip_smoke.time_ms(plain, n),
               "plain_graph_ms": graph_ms(plain, n)}
        if library is not None:
            ev_l = device_events(library, n, f"{name}_library")
            row["library_device_us"] = sum(e["dur"] for e in ev_l) / n
            row["library_event_ms"] = chip_smoke.time_ms(library, n)
        print(f"{name}: " + " ".join(f"{k}={v:.4f}" for k, v in row.items()),
              flush=True)
        out[name] = row
    return out


def profile_decode(params, cfg, dev) -> dict:
    rng = np.random.default_rng(2)
    decode = beam_eval.make_beam_decoder(cfg, BeamConfig(beam_size=4,
                                                         max_steps=120))
    out = {}
    for bucket in (128, 256, 512):
        batch = {"logmel": rng.normal(size=(8, bucket, cfg.feat_length))
                 .astype(np.float32), "logmel_len": np.full(8, bucket)}
        decode(params, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens, lens, _ = decode(params, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        busy = busy_us(device_events(lambda: decode(params, batch), 1,
                                     f"decode_{bucket}")) / 1e3
        feats = torch.tensor(batch["logmel"], device=dev)
        flens = torch.tensor(batch["logmel_len"], device=dev)
        seq2seq.encode(params, cfg, feats, flens)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seq2seq.encode(params, cfg, feats, flens)
        torch.cuda.synchronize()
        enc = (time.perf_counter() - t0) * 1e3
        row = {"wall_ms": wall, "busy_ms": busy, "busy_share": busy / wall,
               "encoder_wall_ms": enc, "steps": int(lens.max())}
        print(f"decode bucket {bucket}: "
              + " ".join(f"{k}={v:.4f}" if isinstance(v, float)
                         else f"{k}={v}" for k, v in row.items()), flush=True)
        out[f"decode_{bucket}"] = row
    return out


def profile_one_utterance(params, cfg, dev) -> dict:
    """One 512-frame utterance at beam 4 (120 steps): the whole decode
    through make_beam_decoder (kernel #15's route at B=1), and the search
    alone on the same encoder output by either route (#15, and the
    per-step route of kernels #11, #12, #14): wall, device busy time and
    share, and #15's device time."""
    rng = np.random.default_rng(3)
    bc = BeamConfig(beam_size=4, max_steps=120)
    batch = {"logmel": rng.normal(size=(1, 512, cfg.feat_length))
             .astype(np.float32), "logmel_len": np.array([512])}
    decode = beam_eval.make_beam_decoder(cfg, bc)
    feats = torch.tensor(batch["logmel"], device=dev)
    states, _, lens = seq2seq.encode(params, cfg, feats, torch.tensor(
        batch["logmel_len"], device=dev))
    depth = cfg.num_layers["char"]
    enc, enc_lens = states[depth], lens[depth]
    dec, dcfg = params["decoder_char"], cfg.decoders["char"]
    out = {}
    for name, fn in (
            ("one_utterance_decode", lambda: decode(params, batch)),
            ("one_utterance_mega", lambda: beam.beam_decode(
                dec, dcfg, bc, enc, enc_lens)),
            ("one_utterance_steps", lambda: beam.beam_decode_steps(
                dec, dcfg, bc, enc, enc_lens))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        events = device_events(fn, 1, name)
        busy = busy_us(events) / 1e3
        row = {"wall_ms": wall, "busy_ms": busy, "busy_share": busy / wall,
               "beam_mega_device_ms": sum(
                   e["dur"] for e in events
                   if "beam_mega_kernel" in e["name"]) / 1e3,
               "device_launches": len(events)}
        print(f"{name}: " + " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in row.items()), flush=True)
        out[name] = row
    return out


# The port's kernels by name; a name that contains another comes first.
OWN_KERNELS = ("lstm_bidir_fwd_kernel", "lstm_bwd_walk_kernel",
               "lstm_bwd_gates_kernel", "lstm_bwd_layout_kernel",
               "dw_partial_kernel", "dw_sum_kernel", "dec_train_fwd_kernel",
               "dec_train_bwd_kernel", "lstm_seq_fwd_kernel",
               "dec_train_gru_fwd_kernel", "dec_train_gru_bwd_kernel",
               "gru_fwd_kernel", "gru_bwd_chain_kernel", "cells_fused_kernel",
               "output_fused_kernel", "beam_select_kernel",
               "beam_mega_kernel", "attn_output_kernel",
               "transducer_fwd_kernel", "transducer_bwd_kernel",
               "ctc_prefix_kernel", "lstm_wide_fwd_kernel",
               "lstm_wide_fwd_resident_kernel", "lstm_wide_bwd_kernel",
               "mhsa_fwd_kernel")
# PyTorch's own kernels by what they compute (the rest is "other").
TORCH_KERNELS = (("gemm", "torch_matmul"), ("softmax", "torch_softmax"))


def kernel_group(event: dict) -> str:
    """The split's key for a device event: its kernel's name; the
    backward's walk and gate product (csrc/lstm_bidir_bwd.cu) by direction
    count (the walk's grid y, the product's grid z: 2 for A's backward, 1
    for #5, a forward-only layer's or the prediction network's)."""
    name = event["name"]
    own = next((k for k in OWN_KERNELS if k in name), None)
    if own in ("lstm_bwd_walk_kernel", "lstm_bwd_gates_kernel"):
        grid = event.get("args", {}).get("grid")
        if grid:
            axis = 1 if own == "lstm_bwd_walk_kernel" else 2
            dirs = "both directions" if grid[axis] > 1 else "one direction"
            return f"{own} ({dirs})"
    if own is not None:
        return own
    low = name.lower()
    return next((g for k, g in TORCH_KERNELS if k in low), "other")


CHAIN = "attention_chain"


def _within(point: dict, spans: list[dict]) -> bool:
    return any(s["tid"] == point["tid"] and s["ts"] <= point["ts"]
               <= s["ts"] + s.get("dur", 0) for s in spans)


def chain_launches(events: list[dict]) -> set:
    """The correlation ids of the kernels launched by the attention chain:
    inside a CHAIN annotation (the forward), or by a backward op whose
    sequence number is that of a forward op inside one (autograd's
    backward of the chain, on its own thread)."""
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == CHAIN]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    seqs = {o.get("args", {}).get("Sequence number") for o in ops
            if _within(o, spans)} - {None}
    spans += [o for o in ops if "Fwd thread id" in o.get("args", {})
              and o["args"].get("Sequence number") in seqs]
    return {e["args"]["correlation"] for e in events
            if e.get("cat") == "cuda_runtime"
            and "correlation" in e.get("args", {}) and _within(e, spans)}


def profile_step(label: str, run, frames: int, chain: bool = False) -> dict:
    """Wall, device busy share and per-kernel device time of one call of
    run() (a training step), after two warm-up calls. chain: the kernels
    of the transformer's attention chain (mhsa.attend_reference, forward
    and backward) are grouped apart as CHAIN."""
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    ids = set()
    if chain:
        real = mhsa.attend_reference

        def marked(*args, **kw):
            with torch.profiler.record_function(CHAIN):
                return real(*args, **kw)

        mhsa.attend_reference = marked
        try:
            every = device_events(run, 1, label.split()[0], keep_all=True)
        finally:
            mhsa.attend_reference = real
        ids = chain_launches(every)
        events = [e for e in every if e.get("cat") in DEVICE_CATS]
    else:
        events = device_events(run, 1, label.split()[0])
    split = {}
    for e in events:
        name = (CHAIN if e.get("args", {}).get("correlation") in ids
                else kernel_group(e))
        ms, n = split.get(name, (0.0, 0))
        split[name] = (ms + e["dur"] / 1e3, n + 1)
    busy = busy_us(events) / 1e3
    row = {"wall_ms": wall, "busy_ms": busy, "busy_share": busy / wall,
           "frames": frames,
           "kernels": {k: {"device_ms": ms, "launches": n}
                       for k, (ms, n) in sorted(split.items())}}
    print(f"{label}: wall {wall:.2f} ms, busy {busy:.2f} ms "
          f"({busy / wall:.3f})", flush=True)
    for k, v in row["kernels"].items():
        print(f"  {k}: {v['device_ms']:.3f} ms device, {v['launches']} "
              "launches", flush=True)
    return row


def profile_joint(dev) -> dict:
    """The transducer's joint alone at its step's shapes (B=128, T'=48,
    U+1=48, joint 256, V=40): lattice_logprobs forward and the backward to
    the encoder's and prediction network's outputs and the joint's
    leaves, split as a step is."""
    cfg = chip_smoke.transducer_cfg()
    params = step.init_params(torch.Generator().manual_seed(0), cfg,
                              device=dev)
    B, T, U = chip_smoke.RNNT_B, chip_smoke.RNNT_T, chip_smoke.RNNT_U
    gen = torch.Generator(device=dev).manual_seed(3)
    enc = torch.randn(B, T, 2 * cfg.encoder.hidden_size, device=dev,
                      generator=gen, requires_grad=True)
    pred = torch.randn(B, U + 1, cfg.decoders["char"].hidden_size_dec,
                       device=dev, generator=gen, requires_grad=True)
    labels = torch.randint(3, 40, (B, U), device=dev, generator=gen)
    leaves = [enc, pred] + [v.requires_grad_(True) for v in
                            params["joint"]["out"].values()]

    def run():
        blank, label = transducer.lattice_logprobs(params, labels, enc, pred)
        torch.autograd.grad(blank.sum() + label.sum(), leaves)

    return {"transducer_joint": profile_step(
        f"transducer_joint B={B} T'={T} U={U}", run, 0)}


def profile_gru_decode(dev) -> dict:
    """The `-gru` flagship's beam search (beam 4, 120 steps) on the
    encoder output of 512-frame utterances: a batch of 8 by the per-step
    route and one utterance by kernel #15."""
    cfg = chip_smoke.flagship_cfg(cells="gru")
    params = seq2seq.init(torch.Generator().manual_seed(0), cfg, device=dev)
    rng = np.random.default_rng(4)
    feats = torch.tensor(rng.normal(size=(8, 512, cfg.feat_length)).astype(
        np.float32), device=dev)
    states, _, lens = seq2seq.encode(params, cfg, feats, torch.full(
        (8,), 512, device=dev))
    depth = cfg.num_layers["char"]
    enc, enc_lens = states[depth], lens[depth]
    dec, dcfg = params["decoder_char"], cfg.decoders["char"]
    bc = BeamConfig(beam_size=4, max_steps=120)
    return {
        "gru_decode_steps_b8": profile_step(
            "gru_decode_steps_b8 (per-step route, beam 4)",
            lambda: beam.beam_decode_steps(dec, dcfg, bc, enc, enc_lens), 0),
        "gru_decode_mega_b1": profile_step(
            "gru_decode_mega_b1 (#15, beam 4)",
            lambda: beam.beam_decode(dec, dcfg, bc, enc[:1], enc_lens[:1]),
            0)}


def profile_joint_decode(dev) -> dict:
    """The flagship hybrid's (random weights from seed 0) decode of a batch
    of 8 512-frame utterances at beam 4 through make_beam_decoder, by joint
    CTC/attention beams (joint 0.3: kernel #16 every step beside #11, #12
    and #14) and by the plain beam of the same model: wall, device busy
    share and per-kernel split, as a step's."""
    cfg = chip_smoke.hybrid_cfg(40, None)
    params = step.init_params(torch.Generator().manual_seed(0), cfg,
                              device=dev)
    rng = np.random.default_rng(5)
    batch = {"logmel": rng.normal(size=(8, 512, cfg.feat_length)).astype(
        np.float32), "logmel_len": np.full(8, 512)}
    out = {}
    for name, joint in (("joint_decode_b8", chip_smoke.JOINT_CTC),
                        ("hybrid_beam_decode_b8", 0.0)):
        decode = beam_eval.make_beam_decoder(cfg, BeamConfig(
            beam_size=4, max_steps=120, joint_ctc=joint))
        with torch.no_grad():
            out[name] = profile_step(f"{name} (beam 4, joint {joint})",
                                     lambda: decode(params, batch), 0)
    return out


def profile_train(cfg, dev, name: str | None = None) -> dict:
    """One asr_step of `cfg` at the bench's train shape, and one lm_step at
    the LM task's shape when `cfg` has a phone task and an LSTM char
    decoder (the recipe's model; a GRU char decoder has no LM task), keyed
    "lm_step" for the flagship and "<name>_lm_step" for a named step. A
    transformer encoder's attention chain is split apart (profile_step's
    `chain`)."""
    V = cfg.decoders["char"].vocab_size
    lm_cfg = LMConfig(vocab_size=V,
                      lm_hidden_size=cfg.decoders["char"].lm_hidden_size)
    params = step.init_params(torch.Generator().manual_seed(0), cfg,
                              device=dev)
    asr_step, lm_step = step.make_train_step(cfg, lm_cfg, device=dev)
    holder = {"state": step.create_state(params, cfg, lm_cfg, device=dev)}
    batch = chip_smoke.train_batch(np.random.default_rng(6),
                                   chip_smoke.TRAIN_B, cfg)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    gen = torch.Generator(device=dev).manual_seed(6)

    def one_asr():
        holder["state"], _ = asr_step(holder["state"], batch, gen)

    lm_key = "lm_step" if name is None else f"{name}_lm_step"
    name = name or ("train_step" if cfg.tasks == ["char"]
                    else "multitask_step")
    out = {name: profile_step(
        f"{name} B={chip_smoke.TRAIN_B} T={chip_smoke.TRAIN_T} "
        f"L={chip_smoke.TRAIN_L}", one_asr, int(batch["logmel_len"].sum()),
        chain=cfg.encoder.encoder_type == "transformer")}
    if "phone" in cfg.tasks and cfg.decoders["char"].use_lstm:
        ids, lens, valid = (torch.as_tensor(a, device=dev) for a in
                            chip_smoke.lm_batch(np.random.default_rng(10),
                                                chip_smoke.LM_B, V))

        def one_lm():
            holder["state"], _ = lm_step(holder["state"], ids, lens, gen,
                                         valid)

        out[lm_key] = profile_step(
            f"{lm_key} B={chip_smoke.LM_B} T={chip_smoke.LM_T} "
            f"H={lm_cfg.lm_hidden_size}", one_lm, 0)
        out[lm_key]["tokens"] = int(lens.sum())
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("prof_port: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    build.library()
    cfg = chip_smoke.flagship_cfg()
    with torch.no_grad():
        params = seq2seq.init(torch.Generator().manual_seed(0), cfg,
                              device=dev)
        result = {"card": card, **profile_kernels(params, cfg, dev),
                  **profile_decode(params, cfg, dev),
                  **profile_one_utterance(params, cfg, dev),
                  **profile_gru_decode(dev)}
    result.update(profile_train(cfg, dev))
    result.update(profile_train(chip_smoke.flagship_cfg(
        40, chip_smoke.PHONE_VOCAB), dev))
    result.update(profile_train(chip_smoke.flagship_cfg(
        40, chip_smoke.PHONE_VOCAB, "gru"), dev, "gru_step"))
    result.update(profile_train(chip_smoke.transducer_cfg(), dev,
                                "transducer_step"))
    result.update(profile_joint(dev))
    result.update(profile_train(chip_smoke.hybrid_cfg(), dev, "hybrid_step"))
    result.update(profile_train(chip_smoke.ctc_cfg(), dev, "ctc_step"))
    result.update(profile_joint_decode(dev))
    result.update(profile_train(chip_smoke.deep_cfg(), dev, "deep_step"))
    result.update(profile_train(chip_smoke.transformer_cfg(), dev,
                                "transformer_step"))
    text = json.dumps(result)
    if args.out:
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
