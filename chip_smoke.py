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
   - serving kernels A, B, C, D at the serving shapes (A beside cuDNN's
     nn.LSTM forward under torch.inference_mode);
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
   - kernel #17, the transducer's lattice loss, forward and backward, at
     the bench's transducer lattice (B=128, T'=48, U=47, ragged lengths;
     the lattices of a random joint's log-softmax): the loss within 1e-5
     relative of the plain version's, both gradients within 1e-5
     absolute (on the same alpha and loss, at the step's g = 1/B), and
     at g = 1 both float32 chains' error against the plain version in
     float64; library none;
   - kernel #16, the CTC prefix-score frame scan of one joint
     CTC/attention beam step, on its inputs as CTCPrefixScorer gathers
     them from random CTC logits (ragged lengths), from a fresh and a
     mid-decode state (a slot at NEG_INF, `last` = -1 rows): B=8, k=4,
     T=64, P=V=40 (the serving shape: the row's numbers); B=1, k=16; a
     pre-beam P=k=4 < V; T=61. psi, rn and rb within 1e-5 of
     max(|value|, 1), entries at NEG_INF on both sides or neither;
     library none;
   - the deep decoders' kernels on deep_cfg (the flagship widths with a
     two-layer char decoder, 1280-wide LM cells through SimpleProjection
     and ind_softmax): kernel #4 in its inference, masked and training
     forms and #5's wide form (the kernel and the dW matmul beside it
     timed apart, and split by device time into the gate pre-pass, the
     walk and the dW matmul) at the LM task's shape with H=1280 (B=128,
     T=120, lengths 24-120), without and with the lengths' carry mask
     (lstm_bwd_wide_masked), beside cuDNN's unidirectional nn.LSTM; #15 on the
     deep decoder as #15's cases above; the deep branches of #8/#9 and of
     #10 (`-gru`) at B=128, 47 steps, 48 encoder frames, sampling on every
     other step and dropout with the inter-layer masks;
   the rows of the redesigned recurrences (#1's two forms, A's backward
   and #5 at both shapes, #4's three forms, #5's wide form) also give
   their time a step (us_per_step) and the route of the launches they
   timed, from the plan the wrapper kept (kernel_route: resident or
   streamed, with #1's and the backward's rows a cluster, clusters and
   cluster size, #4's blocks, #5-wide's clusters of 2 blocks), and fail
   unless it is resident (H=256 and 1280);
   every row with a library time gives its ratio to it in the same run
   (library_ratio); each main path below must take those resident routes
   alone (and #18 its on-chip route);
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
   routes' times side by side;
11. the transducer family (`-model_family transducer`): the flagship
   encoder under a 1-layer LSTM prediction network (emb 256, hidden 256)
   and a 256-wide joint, V=40 (transducer_cfg): (a) one asr_step at B=16
   on the card and on the CPU must agree (loss, gradients, params after;
   phase 5's tolerances), three steps at B=128, T=384, L=48 with every
   loss finite and #17 both ways, A and its backward, #3 and #5
   launched, their step time and frames/s, and one step's device split
   (tools/prof_port.py); (b) the Trainer on phase 6's corpus without the
   LM task (train, greedy dev WER, save, exact resume); (c) `cli.main
   -model_family transducer`: train, `-dev` greedy and at beam 4, `-test
   -beam_size 4`; (d) phase 4's serving burst (beam 4), and one batch of
   8 decoded on the card and on the CPU, greedily and at beam 4, with
   identical token rows. No decode launches an attention-decoder kernel;
   serving computes no loss, so it launches A and not #17.
12. the CTC family (`-model_family ctc`: the flagship encoder under a
   512 -> 40 CTC head, ctc_cfg) and the hybrid CTC/attention family
   (`-ctc_weight 0.3`: the flagship with that head on the char depth,
   hybrid_cfg): (a) one hybrid asr_step (char + phone) at B=16 on the card
   and on the CPU must agree (loss, gradients, params after; phase 5's
   tolerances), then three steps at B=128, T=384, L=48, every loss finite,
   A, its backward and #8/#9 launched, their step time and frames/s and
   one step's device split (tools/prof_port.py); (b) the same for the CTC
   family's step (A and its backward; the CTC loss is plain PyTorch, as
   the JAX package leaves it to XLA), no decoder kernel; (c) both
   families' Trainers on phase 6's corpus without the LM task (train,
   greedy dev WER: the attention decoder for the hybrid, best path for
   the CTC family; save, exact resume); (d) `cli.main -ctc_weight 0.3`:
   train, `-dev -beam_size 4 -joint_ctc 0.3` at a batch of 1 and of 64
   and `-test` likewise (joint beams: #16 every step, #15 never);
   `cli.main -model_family ctc`: train, `-dev` greedy and at beam 4; (e)
   the hybrid serves phase 4's burst by joint beams, and one batch of 8
   decoded on the card and on the CPU agrees up to near-ties (< 1e-3);
   the CTC family's burst at beam 1 and 4, and its batch of 8 on the card
   and the CPU with identical token rows; then the device split of a
   joint decode of 8 utterances beside the plain beam's
   (tools/prof_port.py).
13. the deep decoders (deep_cfg; `-num_layers_dec 2 -lm_hsize 1280
   -ind_softmax`): (a) one char + phone asr_step at B=16 on the card and
   on the CPU, LSTM and `-gru`, and one lm_step at H=1280, must agree
   (phase 5's tolerances); (b) three asr_steps at B=128, T=384, L=48 and
   three lm_steps at B=128, T=120: every loss finite, #4's training form,
   #5's wide form and #8/#9 launched, #8 at depth 2 for the char decoder
   and 1 for the phone decoder (dec_train.DEPTHS), #3 and #5 not; their
   times, frames/s and tokens/s and the step's device split
   (tools/prof_port.py); (c) the Trainer on phase 6's corpus with the LM
   task (train, greedy dev WER, save, exact resume); (d) `cli.main` with
   those flags, LSTM and `-gru`: train (the char_dec_dep_2_ run
   directory), `-dev -beam_size 4 -buck_batch_sizes 1` (one #15 launch an
   utterance) and `-test -beam_size 4` at 64 (the per-step route); (e)
   phase 4's serving burst on the deep model, and one batch decoded on
   the card equal to the CPU's up to near-ties.
14. the transformer encoder family (`-encoder_type transformer -num_heads 4
   -ffn_mult 4 -enc_subsample 8`: bench.py's `_measure_transformer`, 4
   blocks at d_model 512 under the flagship's char and phone LSTM decoders;
   transformer_cfg) with kernel #18, the encoder's self-attention core,
   which runs in inference when E2E_ASR_MHSA_KERNEL is set (as in the JAX
   package): (a) #18 against its plain version at B=8, T'=64 without and
   with the relative-position matrix and at B=64, T'=48 (ragged lengths,
   one zero-length row, whose probs must be uniform), within 1e-5, in both
   forms: the out-only form (the encoder's call; rows mhsa, mhsa_rel,
   mhsa_test) beside scaled_dot_product_attention on the same out, and the
   probs form (rows *_probs) beside the plain chain, the out-only form's
   out equal to the probs form's bit for bit; device times a call from a
   CUDA graph of 50 calls, and each form's route; (b) one char + phone
   asr_step at B=16 on the card and on the CPU, for this form and one with
   rel_pos_bias and a conv module of kernel 15, must agree (phase 5's
   tolerances); (c) three steps of each at B=128, T=384, L=48, every loss
   finite, #8/#9 launched and neither #18 nor a recurrent encoder's kernel,
   their times and frames/s, and the step's device split
   (tools/prof_port.py: matmuls, the attention chain, the rest); (d) the
   Trainer on phase 6's corpus with the LM task (train, greedy dev WER,
   save, exact resume); (e) `cli.main` with those flags and the gate set:
   train (the xfmr_4h_ run directory), `-dev -beam_size 4 -buck_batch_sizes
   1` (one #15 launch an utterance) and `-test -beam_size 4` at 64, each
   launching #18; (f) phase 4's serving burst with the gate on (#18
   launched) and off (not), and its three batches of 8, and one batch of
   the rel + conv-15 form, decoded with the gate on and off, equal up to
   near-ties (< 1e-3).
Each main-path run (serving, ASR training, LM + multitask, recipe, each
entry-point run, the GRU runs, the #13 runs, the transducer runs, the CTC
and hybrid runs, the deep decoders' runs, the transformer's runs) counts
its kernels' launches
from zero; a row's
`launches` in the kernels line is their sum over those runs. The line before the last is a JSON object with
the per-kernel numbers; the last line is {"ok": true, "device": {...}}.
float32 throughout, TF32 off. No phase runs at a cut depth: the whole run
takes some 4 to 6 minutes on an H100, the build included; the script
prints its total.
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
from e2e_asr_tpu_torch.eval import beam, beam_eval, ctc_beam, transducer_beam
from e2e_asr_tpu_torch.eval.ctc_prefix import CTCPrefixScorer
from e2e_asr_tpu_torch.eval.serving import BatchingTranscriber
from e2e_asr_tpu_torch.kernels import (attn_output, beam_mega, beam_select,
                                       build, ctc_prefix, dec_step,
                                       dec_train, dec_train_gru, gru_seq,
                                       lstm_bidir, lstm_seq, mhsa)
from e2e_asr_tpu_torch.kernels import transducer as rnnt_kernel
from e2e_asr_tpu_torch.models import (attn_decoder, encoder, seq2seq,
                                      transducer)
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
       "cells_fused_gru": 1e-4, "attn_output_fused": 1e-4,
       "transducer_fwd": 1e-5, "transducer_bwd": 1e-5, "ctc_prefix": 1e-5,
       "lstm_seq_wide": 1e-4, "lstm_seq_wide_masked": 1e-4,
       "lstm_seq_wide_train": 1e-4, "lstm_bwd_wide": 1e-4,
       "dec_train_fwd_deep": 1e-4, "dec_train_bwd_deep": 1e-4,
       "dec_train_gru_fwd_deep": 1e-4, "dec_train_gru_bwd_deep": 1e-4,
       "lstm_bwd_wide_masked": 1e-4,
       "mhsa": 1e-5, "mhsa_rel": 1e-5, "mhsa_test": 1e-5, "mhsa_probs": 1e-5,
       "mhsa_rel_probs": 1e-5, "mhsa_test_probs": 1e-5}
RELATIVE = {"lstm_bidir_bwd", "lstm_bwd", "dec_train_bwd", "lstm_bwd_lm",
            "gru_bidir_bwd", "gru_bwd", "dec_train_gru_bwd",
            "dec_train_gru_bwd_phone", "lstm_bwd_wide", "lstm_bwd_wide_masked",
            "dec_train_bwd_deep",
            "dec_train_gru_bwd_deep"}
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
# Kernel #17's lattice at the bench's transducer shape
# (bench.py:_measure_transducer): T' = 384 / 8 encoder frames, U = L - 1
# labels. Its forward is held per example to 1e-5 of the plain version's
# loss (relative), its backward to 1e-5 absolute on both gradients.
RNNT_B, RNNT_T, RNNT_U = TRAIN_B, TRAIN_T // 8, TRAIN_L - 1
# Kernel #16's cases (B, k, T, V, pre_beam): the serving shape first (its
# row's numbers: B=8, k=4, the 64 encoder frames of a 512-frame bucket,
# P = V = 40), then one utterance at k=16, a pre-beam P = k = 4 < V, and
# T=61 (no multiple of the TPU kernel's 8-frame block); each from a fresh
# and from a mid-decode state (a slot at NEG_INF, `last` = -1 rows). Held
# to 1e-5 of max(|value|, 1) (chains of 64 float32 lse steps reaching
# hundreds of nats), entries below NEG_INF / 2 on both sides or neither.
CTC_PREFIX_CASES = [(8, 4, MEGA_T, 40, None), (1, 16, MEGA_T, 40, None),
                    (8, 4, MEGA_T, 40, 4), (8, 4, 61, 40, None)]
JOINT_CTC = 0.3
WIDE_LM = 1280     # deep_cfg's LM cell: the narrowest width past #3's cap
                   # at which the JAX package itself streams W_h (#4)
# Kernel #18's cases (name, B, T', relmat): the serving burst's largest
# bucket (512 frames -> T' = 64 after the 8x subsample, at most 8 requests
# a batch) without and with the relative-position matrix, and `-test` at a
# batch of 64 (T' up to 47; 48 here); nh 4, hd 128 (d_model 512). Ragged
# lengths, the last row of zero length (its probs uniform). Held to 1e-5
# absolute on out and probs (sums of up to 128 float32 products).
MHSA_CASES = [("mhsa", 8, 64, False), ("mhsa_rel", 8, 64, True),
              ("mhsa_test", 64, 48, False)]
XFMR_FLAGS = ["-encoder_type", "transformer", "-num_heads", "4",
              "-ffn_mult", "4", "-enc_subsample", "8"]


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


def graph_ms(fn, n: int) -> float:
    """Per-call time of n calls of fn replayed from one captured CUDA graph:
    the device's time without the host's launch cost."""
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


def transducer_cfg(char_vocab: int = 40):
    """The flagship encoder under the transducer family's prediction
    network (one LSTM layer, emb 256, hidden 256) and joint (256 wide):
    `-model_family transducer` at the flagship widths."""
    base = flagship_cfg(char_vocab)
    dec = dataclasses.replace(base.decoders["char"], joint_dim=256)
    return dataclasses.replace(base, model_family="transducer",
                               decoders={"char": dec})


def hybrid_cfg(char_vocab: int = 40, phone_vocab: int | None = PHONE_VOCAB):
    """The flagship with a CTC head (512 -> V) on the char depth, trained
    with ctc_weight 0.3: `-ctc_weight 0.3` at the flagship widths (char +
    phone by default)."""
    return dataclasses.replace(flagship_cfg(char_vocab, phone_vocab),
                               ctc_weight=JOINT_CTC)


def ctc_cfg(char_vocab: int = 40):
    """The flagship encoder under a CTC head: `-model_family ctc` at the
    flagship widths."""
    return dataclasses.replace(flagship_cfg(char_vocab), model_family="ctc")


def deep_cfg(cells: str = "lstm", char_vocab: int = 40,
             phone_vocab: int | None = PHONE_VOCAB):
    """The deep decoders at the flagship widths: the char decoder two
    layers deep, both decoders' LM cells WIDE_LM wide (so SimpleProjection
    1280 -> 256 in both, as the JAX package's config.py sets them) and
    ind_softmax; the phone decoder one layer (config.py: only the char
    decoder can be deep). `-num_layers_dec 2 -lm_hsize 1280 -ind_softmax`,
    with GRU cells throughout for cells="gru" (`-gru`, no LM task)."""
    base = flagship_cfg(char_vocab, phone_vocab, cells)
    return dataclasses.replace(base, decoders={
        t: dataclasses.replace(d, lm_hidden_size=WIDE_LM, ind_softmax=True,
                               num_layers_dec=2 if t == "char" else 1)
        for t, d in base.decoders.items()})


def transformer_cfg(char_vocab: int = 40,
                    phone_vocab: int | None = PHONE_VOCAB, rel: bool = False,
                    conv: int = 0):
    """The transformer encoder family at bench.py's widths
    (`_measure_transformer`: the flagship with encoder_type "transformer",
    4 heads, FFN x4, an 8x subsample: 4 blocks at d_model 512) under the
    flagship's LSTM attention decoders, char on block 4 and the recipe's
    phone decoder on block 3 (XFMR_FLAGS); rel and conv add the
    relative-position bias and a conv module of that kernel size."""
    base = flagship_cfg(char_vocab, phone_vocab)
    return dataclasses.replace(base, encoder=dataclasses.replace(
        base.encoder, encoder_type="transformer", num_heads=4, ffn_mult=4,
        subsample=8, rel_pos_bias=rel, conv_kernel=conv))


class Recorder:
    """Holds each kernel to its plain version and keeps its JSON row."""

    def __init__(self):
        self.rows = []

    def __call__(self, name, source, replaces, got, want, fn, ref, n, n_ref,
                 work, library=None, steps=None, route=None, timer=None,
                 **extra):
        """timer(fn, n): the time a call (CUDA events by default)."""
        abs_err, rel_err, kind = self.hold(name, got, want)
        ms = time_ms(fn, n) if timer is None else timer(fn, n)
        launched = None if route is None else route()  # of the timed calls
        self.add(name, source, replaces, abs_err,
                 f"max_rel_err={rel_err:.3e} tolerance={TOL[name]:.0e} "
                 f"({kind})", ms,
                 time_ms(ref, n_ref, warmup=1) if timer is None
                 else timer(ref, n_ref),
                 work, None if library is None else library(), steps,
                 launched, **extra)

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
            library_ms, steps=None, route=None, **extra):
        """Print and keep a row whose error has been checked; with `steps`
        (a recurrence's time steps) also its time a step and, with a
        library time, the ratio to it; with `route`, the hand-written
        kernel's route that ran (kernel_route)."""
        bound_ms, bound_by = bound(*work)
        lib = "none" if library_ms is None else f"{library_ms:.4f}"
        if steps:
            extra["us_per_step"] = ms / steps * 1e3
        if library_ms:
            extra["library_ratio"] = ms / library_ms
        print(f"kernel {name}: max_abs_err={abs_err:.3e} {note} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bound_ms:.4f} ({bound_by}) library_ms={lib}"
              + "".join(f" {k}={v:.4f}" for k, v in extra.items())
              + ("" if route is None else f" kernel_route=[{route}]"),
              flush=True)
        self.rows.append({"name": name, "route": "cuda", "source": source,
                          "replaces": replaces, "max_abs_err": abs_err,
                          "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": library_ms, **extra,
                          **({} if route is None
                             else {"kernel_route": route})})


def launched_walk(plan: dict, kernel: str, H: int) -> str:
    """The route of an LSTM walk's last launch (kernel #1, or #2 / #5),
    from the plan its wrapper kept: the route, the rows a cluster walks and
    a product lane's rows and threads, the clusters and their size beside
    what the card holds at once. Fails unless the walk at H = 256 (the
    flagship's width, which every row that reads this has) was resident."""
    if H == 256 and plan.get("route") != "resident":
        fail(f"kernel {kernel} did not take its resident route at H=256: "
             f"{plan}")
    return (f"{plan['route']}, {plan['Rg']} rows a cluster, lanes of "
            f"{plan.get('RL', plan['Rg'])} rows x {plan['S']} threads, "
            f"{plan.get('n_dirs', 2) * plan['groups']} clusters of "
            f"{plan.get('cluster', 8)} (the card holds {plan['clusters']})")


def launched_wide(H: int) -> str:
    """The route of kernel #4's last launch, from the plan its wrapper
    kept (its blocks). Fails unless it was resident at H = 1280."""
    p = lstm_seq.WIDE_FWD_LAST_PLAN
    if H == 1280 and p.get("route") != "resident":
        fail(f"kernel #4 did not take its resident route at H=1280: {p}")
    return f"{p['route']}, {p['blocks']} blocks of {p['units']} units"


def launched_wide_bwd(H: int) -> str:
    """The walk of #5-wide's last launch, from the plan its wrapper kept.
    Fails unless it was resident at H = 1280."""
    p = lstm_seq.WIDE_BWD_LAST_PLAN
    if H == 1280 and p.get("route") != "resident":
        fail(f"#5's wide form did not take its resident walk at H=1280: {p}")
    if p["route"] != "resident":
        return p["route"]
    return (f"resident, {p['clusters']} clusters of {p['cluster']} blocks "
            f"of {p['units']} units (the card holds {p['held']})")


def cudnn_lstm_ms(x, lens, H, bidirectional, backward,
                  rnn=torch.nn.LSTM, inference: bool = False) -> float:
    """cuDNN's nn.LSTM (or `rnn`) on the packed batch (same input width,
    hidden size and lengths): its training forward, its inference forward
    (inference: under torch.inference_mode, on a detached input), or its
    backward as the time of forward + backward less the forward's. Timed
    only, as a yardstick."""
    lstm = rnn(x.shape[-1], H, bidirectional=bidirectional).to(x.device)
    if inference:
        with torch.inference_mode():
            packed = torch.nn.utils.rnn.pack_padded_sequence(
                x.detach(), lens.cpu(), enforce_sorted=False)
            return time_ms(lambda: lstm(packed), 5)
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
           lambda: cudnn_lstm_ms(x, lens, H, True, False, inference=True),
           steps=T,
           route=lambda: launched_walk(lstm_bidir.FWD_LAST_PLAN, "#1", H))

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
    backward on encoder layer 1 (T=384, B=128, H=256), then the decoder's
    training forward and backward (check_dec_train)."""
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
           lambda: cudnn_lstm_ms(x, lens, H, True, False), steps=T,
           route=lambda: launched_walk(lstm_bidir.FWD_LAST_PLAN, "#1", H))
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
           lambda: cudnn_lstm_ms(x, lens, H, True, True), steps=T,
           route=lambda: launched_walk(lstm_bidir.BWD_LAST_PLAN, "#2 / #5", H))
    one_args = (wb, h_bw, c_bw, xb, g_bw, mask)
    got = lstm_bidir.lstm_bwd(*one_args)
    record("lstm_bwd", "e2e_asr_tpu_torch/csrc/lstm_bidir_bwd.cu",
           "e2e_asr_tpu/ops/lstm_pallas.py:975", got,
           lstm_bidir.lstm_bwd_reference(*one_args),
           lambda: lstm_bidir.lstm_bwd(*one_args),
           lambda: lstm_bidir.lstm_bwd_reference(*one_args), 5, 1,
           (3 * lstm_ops, nbytes(*one_args, *got)),
           lambda: cudnn_lstm_ms(x, lens, H, False, True), steps=T,
           route=lambda: launched_walk(lstm_bidir.BWD_LAST_PLAN, "#2 / #5", H))


def check_dec_train(params, cfg, dev, record: Recorder, seed: int,
                    task: str = "char", suffix: str = "") -> None:
    """Phase 3, the decoder's training kernels at the step's shapes: #8/#9
    (LSTM cells) or #10 (GRU cells) on `task`'s decoder, B=128, 47 steps,
    over the encoder frames of its depth (48 for the char decoder, 96 for
    the phone decoder on layer 3), scheduled sampling on every other step,
    dropout (with the inter-layer masks of a deep decoder). Rows
    "dec_train[_gru]_fwd<suffix>" and "..._bwd<suffix>"."""
    dec, dcfg = params[f"decoder_{task}"], cfg.decoders[task]
    use_lstm = dcfg.use_lstm
    mod = dec_train if use_lstm else dec_train_gru
    run = dec_train.dec_train if use_lstm else dec_train_gru.dec_train_gru
    ref = (dec_train.dec_train_reference if use_lstm
           else dec_train_gru.dec_train_gru_reference)
    name = "dec_train" if use_lstm else "dec_train_gru"
    rng = np.random.default_rng(seed)
    rand = lambda *s, scale=1.0: torch.tensor(  # noqa: E731
        rng.normal(size=s).astype(np.float32) * scale, device=dev)
    H = cfg.encoder.hidden_size
    B, S = TRAIN_B, TRAIN_L - 1
    Te = TRAIN_T // 2 ** (cfg.num_layers[task] - 1)
    enc = rand(B, Te, 2 * H, scale=0.5)
    enc_lens = torch.tensor(rng.integers(Te // 2, Te + 1, size=B), device=dev)
    enc_lens[0] = Te
    ids = torch.tensor(rng.integers(3, dcfg.vocab_size, size=(S + 1, B)),
                       device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    _, gumbel, lm_masks, inter = attn_decoder.train_noise(gen, dcfg, S, B,
                                                          dev)
    flags = (torch.arange(S, device=dev) % 2).float()
    M, G, NL = dcfg.emb_size, dcfg.lm_hidden_size, dcfg.num_layers_dec
    sp = "simple_proj" in dec
    lm = dec["lm_cell"]
    with torch.no_grad():
        x = dec["embedding"][ids][:S]
        xs = ([x @ lm["kernel"][:M] + lm["bias"]] if use_lstm else
              [x @ lm["gates"]["kernel"][:M] + lm["gates"]["bias"],
               x @ lm["candidate"]["kernel"][:M] + lm["candidate"]["bias"]])
        weights = [w.contiguous() for w in mod.weight_args(dec, M)]
        hf = enc @ dec["attn_w"]
    amask = dec_train.attn_mask(enc, enc_lens)
    gum_sh, flag_sh = dec_train.shift_noise(flags, gumbel, B)
    lm_masks, inter = dec_train.stack_masks(lm_masks, inter, S, B)
    n_w = len(weights)
    leaves = [t.detach().requires_grad_(True)
              for t in (*weights, hf, enc, *(a.contiguous() for a in xs))]
    args = (leaves[:n_w], *leaves[n_w:n_w + 2], amask, *leaves[n_w + 2:],
            gum_sh, flag_sh, lm_masks, inter)
    depth = mod.DEPTHS.get(NL, 0)
    logits = run(*args, sp=sp)
    if mod.DEPTHS.get(NL, 0) != depth + 1:
        fail(f"{name}{suffix} did not launch at depth {NL}")
    tokens = dec_train.sampled_tokens(logits.detach(), gum_sh)
    with torch.no_grad():
        free = ref(*args, sp=sp)
    parted = near_tie_partings(f"{name}{suffix}", free, tokens, gum_sh,
                               flag_sh)

    def plain():
        return ref(*args, sampled=tokens, sp=sp)

    D, E, A, V = (dcfg.hidden_size_dec, 2 * H, dcfg.attention_vec_size,
                  dcfg.vocab_size)
    # The products of a row and step: every 2-D weight but the embedding
    # rows (EWb, gathered): the LM cell's recurrence, SimpleProjection, the
    # input projection, the decoder layers, the query and projections.
    gathered = 1 if use_lstm else 2
    products = sum(w.numel() for w in weights[gathered:] if w.dim() == 2)
    attn = Te * A * 3 + Te * E * 2
    inputs = nbytes(*leaves, amask, gum_sh, flag_sh, lm_masks, inter)
    src = f"e2e_asr_tpu_torch/csrc/{name}.cu"
    pallas, fwd_line, bwd_line = (
        ("e2e_asr_tpu/ops/dec_train_pallas.py", 337, 656) if use_lstm
        else ("e2e_asr_tpu/ops/dec_train_gru_pallas.py", 323, 613))
    with torch.no_grad():
        record(f"{name}_fwd{suffix}", src, f"{pallas}:{fwd_line}",
               [logits.detach()], [plain()], lambda: run(*args, sp=sp),
               plain, 5, 2,
               (S * B * (2 * products + attn), inputs + nbytes(logits)),
               near_tie_rows=parted)
    dlog = rand(S, B, V)
    got = torch.autograd.grad(logits, leaves, dlog, retain_graph=True)
    want_out = plain()
    want = torch.autograd.grad(want_out, leaves, dlog, retain_graph=True)
    # The data gradients, then the weight gradients: twice the forward's
    # products and about three times its attention work, reading the
    # forward's saves: per row and step the LM cell's 7G (LSTM: gates, c,
    # h, output) or 6G (GRU: r | u, r*h, c, h, output), D through
    # SimpleProjection, M, a layer's 6D (LSTM: gates, c, h) or 5D (GRU),
    # D a dropped layer output below the top, and A + Te + E + D + V.
    per_layer = 6 * D if use_lstm else 5 * D
    saves = S * B * 4 * ((7 if use_lstm else 6) * G + (D if sp else 0) + M
                         + NL * per_layer + (NL - 1) * D + A + Te + E + D
                         + V)
    record(f"{name}_bwd{suffix}", src, f"{pallas}:{bwd_line}", got, want,
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
    LSTM decoder, "beam_mega_gru" for the `-gru` flagship's GRU decoder,
    "beam_mega_deep" for deep_cfg's two-layer decoder with its 1280-wide
    LM cell, SimpleProjection and ind_softmax)
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
    out_key = "output_proj_ind" if dcfg.ind_softmax else "output_proj"
    rigged = dict(dec, **{out_key: {
        "kernel": torch.zeros_like(dec[out_key]["kernel"]),
        "bias": torch.zeros_like(dec[out_key]["bias"])}})
    rigged[out_key]["bias"][EOS_ID] = 50.0
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
           lambda: cudnn_lstm_ms(emb_in, lens_cpu, H, False, True), steps=T,
           route=lambda: launched_walk(lstm_bidir.BWD_LAST_PLAN, "#2 / #5", H))


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


def check_wide_lstm(params, cfg, dev, record: Recorder) -> None:
    """Phase 3, kernel #4 (inference, masked and training forms) and #5's
    wide form at the LM task's shape over deep_cfg's LM cell (B=128,
    T=120, lengths 24-120, H=1280), beside cuDNN's unidirectional nn.LSTM;
    #5's wide form without and with the lengths' carry mask (whose padded
    steps are zero), its kernel and the dW matmul beside it timed apart and
    split into the gate pre-pass, the walk and the dW matmul by device
    time (wide_bwd_split), its route printed: the run fails unless the
    walk at H=1280 is resident."""
    rng = np.random.default_rng(16)
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
    src = "e2e_asr_tpu_torch/csrc/lstm_seq_wide.cu"
    chunked = "e2e_asr_tpu/ops/lstm_pallas.py:353"
    cudnn = lambda: cudnn_lstm_ms(emb_in, lens_cpu, H, False, False)  # noqa
    with torch.no_grad():
        for name, m in (("lstm_seq_wide", None),
                        ("lstm_seq_wide_masked", mask)):
            got = [lstm_seq.lstm_seq(xp, w, m)]
            record(name, src, chunked, got,
                   [lstm_seq.lstm_seq_reference(xp, w, m)],
                   lambda m=m: lstm_seq.lstm_seq(xp, w, m),
                   lambda m=m: lstm_seq.lstm_seq_reference(xp, w, m), 5, 1,
                   (ops, nbytes(xp, w, m, *got)), cudnn, steps=T,
                   route=lambda: launched_wide(H))
        fwd = lstm_seq.lstm_seq_train(xp, w)
        record("lstm_seq_wide_train", src, chunked, fwd,
               lstm_seq.lstm_seq_reference(xp, w, save_c=True),
               lambda: lstm_seq.lstm_seq_train(xp, w),
               lambda: lstm_seq.lstm_seq_reference(xp, w, save_c=True), 5,
               1, (ops, nbytes(xp, w, *fwd)), cudnn, steps=T,
               route=lambda: launched_wide(H))
    g = torch.tensor(rng.normal(size=(T, B, H)).astype(np.float32),
                     device=dev)
    # Gates recompute, dh_{t-1} and dW_h: three [H, 4H] products a
    # row-step; ms is the kernel and the dW matmul together, split into the
    # gate pre-pass, the walk and the dW matmul by their device times.
    for name, m in (("lstm_bwd_wide", None), ("lstm_bwd_wide_masked", mask)):
        h, c = fwd if m is None else lstm_seq.lstm_seq_train(xp, w, m)
        bw_args = (w, h, c, xp, g, m)
        got = lstm_seq.lstm_bwd_wide(*bw_args)
        kernel_ms = time_ms(lambda: lstm_seq.lstm_bwd_wide_dx(*bw_args), 5)
        dw_ms = time_ms(lambda: lstm_seq.wide_dw(h, got[0]), 5)
        split = wide_bwd_split(lambda: lstm_seq.lstm_bwd_wide(*bw_args))
        record(name, src, "e2e_asr_tpu/ops/lstm_pallas.py:975", got,
               lstm_bidir.lstm_bwd_reference(*bw_args),
               lambda: lstm_seq.lstm_bwd_wide(*bw_args),
               lambda: lstm_bidir.lstm_bwd_reference(*bw_args), 5, 1,
               (3 * ops, nbytes(*bw_args, *got)),
               lambda: cudnn_lstm_ms(emb_in, lens_cpu, H, False, True),
               steps=T, route=lambda: launched_wide_bwd(H),
               kernel_ms=kernel_ms, dw_matmul_ms=dw_ms, **split)


def wide_bwd_split(fn, n: int = 3) -> dict:
    """Device time a call of #5-wide's phases in a profiler trace of n
    calls of fn (the kernel and the dW matmul): the gate pre-pass, the
    walk (either route's kernel) and PyTorch's matmul."""
    import prof_port   # tools/, on the path (main)
    phases = {"lstm_bwd_gates_kernel": "prepass_ms",
              "lstm_wide_bwd_walk_kernel": "walk_ms",
              "lstm_wide_bwd_kernel": "walk_ms", "torch_matmul": "dw_ms"}
    split = dict.fromkeys(("prepass_ms", "walk_ms", "dw_ms"), 0.0)
    for e in prof_port.device_events(fn, n, "lstm_bwd_wide"):
        group = prof_port.kernel_group(e).split(" (")[0]
        if group in phases:
            split[phases[group]] += e["dur"] / 1e3 / n
    if not split["walk_ms"] or not split["prepass_ms"]:
        fail(f"#5-wide's phases are missing from its trace: {split}")
    return split


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


def serve(params, cfg, dev, rev_vocab, beam_cfg=None
          ) -> tuple[list, list, dict]:
    """Phase 4a: 24 requests through the batching engine (beam 4, or
    beam_cfg)."""
    rng = np.random.default_rng(2)
    lengths = rng.permutation(np.linspace(40, 512, 24).astype(int))
    feats = [rng.normal(size=(n, cfg.feat_length)).astype(np.float32)
             for n in lengths]
    sent, done = {}, {}
    t0 = time.monotonic()
    with BatchingTranscriber(params, cfg, rev_vocab, device=dev,
                             beam_cfg=beam_cfg or BeamConfig(beam_size=4,
                                                             max_steps=120),
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


def serving_batch(cfg, feats) -> dict:
    """The first 8 requests of a burst as one padded batch of their
    bucket."""
    reqs = feats[:8]
    T = max(x.shape[0] for x in reqs)
    bucket = next(b for b in (128, 256, 512) if T <= b)
    batch = {"logmel": np.zeros((8, bucket, cfg.feat_length), np.float32),
             "logmel_len": np.array([x.shape[0] for x in reqs])}
    for i, x in enumerate(reqs):
        batch["logmel"][i, :x.shape[0]] = x
    return batch


def compare_cpu(params, cfg, feats, beam_cfg=None) -> None:
    """Phase 4b: one batch on the card vs the plain path on the CPU (beam
    4, or beam_cfg)."""
    batch = serving_batch(cfg, feats)
    decode = beam_eval.make_beam_decoder(
        cfg, beam_cfg or BeamConfig(beam_size=4, max_steps=120))
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
            "attn_output_fused": (attn_output, "LAUNCHES"),
            "transducer_fwd": (rnnt_kernel, "FWD_LAUNCHES"),
            "transducer_bwd": (rnnt_kernel, "BWD_LAUNCHES"),
            "ctc_prefix": (ctc_prefix, "LAUNCHES"),
            "lstm_seq_wide": (lstm_seq, "WIDE_LAUNCHES"),
            "lstm_seq_wide_masked": (lstm_seq, "WIDE_MASKED_LAUNCHES"),
            "lstm_seq_wide_train": (lstm_seq, "WIDE_TRAIN_LAUNCHES"),
            "lstm_bwd_wide": (lstm_seq, "WIDE_BWD_LAUNCHES"),
            "dec_train_fwd_deep": (dec_train, "FWD_LAUNCHES"),
            "dec_train_bwd_deep": (dec_train, "BWD_LAUNCHES"),
            "dec_train_gru_fwd_deep": (dec_train_gru, "FWD_LAUNCHES"),
            "dec_train_gru_bwd_deep": (dec_train_gru, "BWD_LAUNCHES"),
            "beam_mega_deep": (beam_mega, "LAUNCHES"),
            "lstm_bwd_wide_masked": (lstm_seq, "WIDE_BWD_LAUNCHES"),
            "mhsa": (mhsa, "LAUNCHES"), "mhsa_rel": (mhsa, "LAUNCHES"),
            "mhsa_test": (mhsa, "LAUNCHES"),
            "mhsa_probs": (mhsa, "PROBS_LAUNCHES"),
            "mhsa_rel_probs": (mhsa, "PROBS_LAUNCHES"),
            "mhsa_test_probs": (mhsa, "PROBS_LAUNCHES")}
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
# The transducer step: the encoder's A and its backward, the prediction
# network's #3 (training form) and #5, and #17 both ways; its decodes run
# the encoder's A (inference form) and no attention-decoder kernel.
TRANSDUCER_PATH = ("lstm_bidir_train", "lstm_bidir_bwd", "lstm_seq_train",
                   "lstm_bwd", "transducer_fwd", "transducer_bwd")
TRANSDUCER_RECIPE_PATH = TRANSDUCER_PATH + ("lstm_bidir",)
ATTENTION_DECODE = ("cells_fused", "cells_fused_gru", "output_fused",
                    "beam_select", "beam_mega", "beam_mega_gru",
                    "attn_output_fused", "ctc_prefix")
# The CTC family's step: the encoder's A and its backward (the CTC loss is
# plain PyTorch, as the JAX package leaves it to XLA); its decodes (best
# path, the prefix beam search) run A and no decoder kernel. The hybrid
# step is the attention step's (A, #8/#9, the CTC head beside them); its
# joint beams run the per-step route with #16 and never #15.
CTC_PATH = ("lstm_bidir_train", "lstm_bidir_bwd")
CTC_RECIPE_PATH = CTC_PATH + ("lstm_bidir",)
JOINT_PATH = ("lstm_bidir", "cells_fused", "output_fused", "beam_select",
              "ctc_prefix")
# deep_cfg's LM cell (1280 wide) trains on #4's training form and #5's
# wide form, never on #3 or #5; its decoders' rows (#8/#9, #10 deep) share
# the flagship rows' counters, and dec_train.DEPTHS tells the depths apart.
DEEP_LM_PATH = ("lstm_seq_wide_train", "lstm_bwd_wide")
DEEP_RECIPE_PATH = TRAIN_PATH + DEEP_LM_PATH + ("lstm_bidir", "cells_fused",
                                                "output_fused")
# The transformer encoder trains in PyTorch (#18 runs in inference only,
# behind E2E_ASR_MHSA_KERNEL) under the LSTM decoders' #8/#9; its decodes
# launch #18 once a block when the gate is set, and never kernel A.
XFMR_TRAIN_PATH = TRAIN_PATH[2:]
XFMR_RECIPE_PATH = XFMR_TRAIN_PATH + LM_PATH + ("cells_fused",
                                                "output_fused")
RECURRENT_ENCODER = ("lstm_bidir", "lstm_bidir_train", "lstm_bidir_bwd",
                     "gru_bidir", "gru_bidir_train", "gru_bidir_bwd")


def decode_rows(gru_decoder: bool) -> tuple[str, str]:
    """The rows of kernels #11 and #15 for a decoder's cells."""
    return (("cells_fused_gru", "beam_mega_gru") if gru_decoder
            else ("cells_fused", "beam_mega"))


def zero_launches() -> None:
    for module, counter in COUNTERS.values():
        setattr(module, counter, 0)
    for routes in (lstm_bidir.FWD_ROUTES, lstm_bidir.BWD_ROUTES,
                   lstm_seq.WIDE_FWD_ROUTES,
                   lstm_seq.WIDE_BWD_ROUTES, mhsa.ROUTES):
        routes.update(dict.fromkeys(routes, 0))
    dec_train.DEPTHS.clear()
    dec_train_gru.DEPTHS.clear()


def read_launches(path: str, required) -> dict:
    """Every counter after a main-path run; fails if a kernel the path
    must launch was not launched."""
    launches = {name: getattr(m, c) for name, (m, c) in COUNTERS.items()}
    print(f"launches in the {path} run: {json.dumps(launches)}", flush=True)
    for name in required:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the {path} path")
    # Every LSTM here at or below H = 296 (the flagship's 256) walks its
    # forward (#1) and backward (#2, #5) on the resident routes, the
    # 1280-wide LM cell runs #4 and #5's wide form on their resident
    # routes, and #18 keeps the encoder's T' <= 64 on chip.
    routes = {"lstm_fwd": dict(lstm_bidir.FWD_ROUTES),
              "lstm_bwd": dict(lstm_bidir.BWD_ROUTES),
              "lstm_seq_wide": dict(lstm_seq.WIDE_FWD_ROUTES),
              "lstm_bwd_wide": dict(lstm_seq.WIDE_BWD_ROUTES),
              "mhsa": dict(mhsa.ROUTES)}
    print(f"routes in the {path} run: {json.dumps(routes)}", flush=True)
    resident = {"mhsa": "onchip"}
    for kernel, rows in (("lstm_fwd", ("lstm_bidir", "lstm_bidir_train")),
                         ("lstm_bwd", ("lstm_bidir_bwd", "lstm_bwd")),
                         ("lstm_seq_wide", ("lstm_seq_wide_train",)),
                         ("lstm_bwd_wide", ("lstm_bwd_wide",)),
                         ("mhsa", ("mhsa",))):
        on, off = ((resident[kernel], "chunked") if kernel in resident
                   else ("resident", "streamed"))
        if any(r in required for r in rows) and (
                routes[kernel][on] <= 0 or routes[kernel][off] > 0):
            fail(f"the {path} path did not take {kernel}'s {on} route "
                 f"alone: {routes[kernel]}")
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
    params, batch and noise; teacher forcing (no sampled token can part).
    A transducer config's noise is the encoder's and the prediction
    network's dropout."""
    if cfg.model_family == "attention":
        cfg = dataclasses.replace(cfg, decoders={
            t: dataclasses.replace(d, samp_prob=0.0)
            for t, d in cfg.decoders.items()})
    B = 16
    batch = train_batch(np.random.default_rng(5), B, cfg)
    gen = torch.Generator().manual_seed(5)
    params = step.init_params(gen, cfg, device="cpu")
    masks, t, enc = {}, TRAIN_T, cfg.encoder
    if enc.encoder_type == "transformer":
        # Each block's (attention, conv, FFN) masks [B, T', D].
        shape = (B, -(-t // enc.subsample), 2 * enc.hidden_size)
        for i in range(1, 5):
            masks[i] = tuple(
                dropout_mask(gen, shape, enc.out_prob, "cpu")
                if j != 1 or enc.conv_kernel else None for j in range(3))
    for i, reduce in enumerate(encoder.layer_plan(enc, 4)
                               if enc.encoder_type == "rnn" else ()):
        masks[i + 1] = dropout_mask(gen, (t, B, 2 * enc.hidden_size),
                                    enc.out_prob, "cpu")
        t = -(-t // enc.skip_step) if reduce else t
    noise = {"encoder": masks}
    if cfg.model_family == "transducer":
        noise["pred"] = transducer.train_noise(gen, cfg, TRAIN_L, B, "cpu")
    else:
        for task, dcfg in cfg.decoders.items():
            noise[task] = attn_decoder.train_noise(gen, dcfg, TRAIN_L - 1,
                                                   B, "cpu")
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
    params = step.init_params(torch.Generator().manual_seed(0), cfg,
                              device=dev)
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
        "decoder_char/embedding",   # the leaves the LM shares, and
        "decoder_char/simple_proj/")  # SimpleProjection where there is one


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


def train_lm_multitask(dev, card, cfg=None, lm_path=LM_PATH,
                       label: str = "LM and multitask") -> dict:
    """Phase 5 (LM, multitask): (a) lm_step card vs CPU; (b) three
    asr_steps of the char + phone model (the flagship's, or `cfg`) at
    B=128, T=384, L=48 and three lm_steps at B=128, T=120, counted from
    zero: the kernels of TRAIN_PATH and `lm_path` launched, #8/#9 by both
    decoders every step at each decoder's depth (dec_train.DEPTHS); (c)
    their times. Returns the launches of (b)."""
    cfg = cfg or flagship_cfg(40, PHONE_VOCAB)
    lm_cfg = LMConfig(vocab_size=40,
                      lm_hidden_size=cfg.decoders["char"].lm_hidden_size)
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
    launches = read_launches(label, TRAIN_PATH + lm_path)
    state = holder["state"]
    if not (all(np.isfinite(asr_losses + lm_losses))
            and int(state.global_step) == 3
            and int(state.lm_global_step) == 3):
        fail(f"multitask losses {asr_losses}, LM losses {lm_losses}")
    depths = {}
    for task in cfg.tasks:
        layers = cfg.decoders[task].num_layers_dec
        depths[layers] = depths.get(layers, 0) + 3
    print(f"{label}: #8 launches by decoder depth {dec_train.DEPTHS}",
          flush=True)
    if ((launches["dec_train_fwd"], launches["dec_train_bwd"]) != (6, 6)
            or dec_train.DEPTHS != depths):
        fail(f"the char and phone decoders did not both run kernels #8/#9 "
             f"every step at their depths {depths}")
    if lm_path != LM_PATH and any(launches[k] for k in LM_PATH):
        fail(f"{label}: the LM step launched #3 or #5 at H="
             f"{lm_cfg.lm_hidden_size}")
    frames, tokens = int(batch["logmel_len"].sum()), int(lens.sum())
    asr_s, lm_s = float(np.mean(asr_times[1:])), float(np.mean(lm_times[1:]))
    print(f"{label}: multitask (char + phone) B={TRAIN_B} T={TRAIN_T} "
          f"L={TRAIN_L} ({card}): losses {asr_losses}; step times "
          f"{[round(t * 1e3, 2) for t in asr_times]} ms; steady step "
          f"{asr_s * 1e3:.2f} ms, {frames / asr_s:.0f} frames/s", flush=True)
    print(f"{label}: LM B={LM_B} T={LM_T} H={lm_cfg.lm_hidden_size} "
          f"({card}): losses {lm_losses}; step times "
          f"{[round(t * 1e3, 2) for t in lm_times]} ms; steady step "
          f"{lm_s * 1e3:.2f} ms, {tokens / lm_s:.0f} tokens/s", flush=True)
    return launches


def recipe(dev, card, cells: str = "lstm") -> dict:
    """Phase 6: train a synthetic corpus at the flagship shape with the
    port's Trainer, evaluate, save, and resume in a second Trainer
    (`cells` as flagship_cfg's, or "transducer", "ctc", "hybrid" or
    "deep", transducer_cfg's, ctc_cfg's, hybrid_cfg's or deep_cfg's; all
    but "lstm", "gru_encoder" and "deep" train without the LM task, which
    a GRU char decoder, the transducer and the CTC family do not have).
    With GRU cells, then also evaluate the trained model on the dev set
    through BeamEvaluator (beam 4) at a batch of 1 (one #15 launch per
    utterance) and, with GRU decoders, at a batch of 64 (the per-step
    route). Returns the launches of each run."""
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
            lm_prob=(0.5 if cells in ("lstm", "gru_encoder", "deep",
                                      "transformer") else 0.0),
            steps_per_checkpoint=3, compute_dtype="float32")
        models = {"transducer": lambda: transducer_cfg(sizes["char"]),
                  "ctc": lambda: ctc_cfg(sizes["char"]),
                  "hybrid": lambda: hybrid_cfg(sizes["char"],
                                               sizes["phone"]),
                  "deep": lambda: deep_cfg("lstm", sizes["char"],
                                           sizes["phone"]),
                  "transformer": lambda: transformer_cfg(sizes["char"],
                                                         sizes["phone"])}
        cfg = ExperimentConfig(
            model=models.get(cells, lambda: flagship_cfg(
                sizes["char"], sizes["phone"], cells))(),
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
            "gru": GRU_RECIPE_PATH, "transducer": TRANSDUCER_RECIPE_PATH,
            "ctc": CTC_RECIPE_PATH,
            "hybrid": TRAIN_PATH + ("lstm_bidir", "cells_fused",
                                    "output_fused"),
            "deep": DEEP_RECIPE_PATH,
            "transformer": XFMR_RECIPE_PATH}[cells])}
        if cells in ("transducer", "ctc") and any(runs[name][k]
                                                  for k in ATTENTION_DECODE):
            fail(f"{name} launched an attention-decoder kernel")
        if cells == "transformer" and any(
                runs[name][k] for k in RECURRENT_ENCODER + ("mhsa",)):
            fail(f"{name} launched a recurrent encoder's kernel, or #18 "
                 "without its gate")
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
        if not (asr and (lm or train_cfg.lm_prob == 0.0)
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


def transducer_lattice(dev, rng, B: int, T: int, U: int, V: int = 40):
    """The two log-prob lattices of a random joint (log-softmax over V of
    normal logits; labels in 3..V-1) with ragged lengths (t_len in
    [T/2, T], u_len in [U/2, U], the first row full), int32 lengths."""
    lp = torch.log_softmax(torch.tensor(rng.normal(size=(B, T, U + 1, V)),
                                        dtype=torch.float32, device=dev), -1)
    labels = torch.tensor(rng.integers(3, V, size=(B, U)), device=dev)
    blank = lp[..., 0].contiguous()
    label = torch.gather(lp[:, :, :U], -1, labels[:, None, :, None].expand(
        B, T, U, 1))[..., 0].contiguous()
    tl = rng.integers(T // 2, T + 1, size=B).astype(np.int32)
    ul = rng.integers(U // 2, U + 1, size=B).astype(np.int32)
    tl[0], ul[0] = T, U
    return [blank, label, torch.tensor(tl, device=dev),
            torch.tensor(ul, device=dev)]


def check_transducer_kernels(dev, record: Recorder) -> None:
    """Phase 3, kernel #17 at the bench's transducer lattice (B=128,
    T'=48, U=47, ragged): the forward's loss against the plain forward's
    (1e-5 relative, per example), the backward's gradients against the
    plain backward's on the same alpha and loss and the step's g = 1/B,
    the mean's gradient (1e-5 absolute). Beside them, at g = 1, the error
    against the plain versions in float64 of the kernels' chain (the
    backward on the forward kernel's alpha and loss) and of the plain
    float32 chain: float32's own rounding of the log-space sums, which
    reach 230 here.
    Bound: the bytes of this data's lattices (the cells t < t_len,
    u <= u_len of each input read, each output written) at 3.35 TB/s;
    the arithmetic (about 8 operations a cell forward, 20 backward) is far
    below it. No PyTorch call computes this loss from the two lattices:
    library none."""
    args = transducer_lattice(dev, np.random.default_rng(17), RNNT_B,
                              RNNT_T, RNNT_U)
    blank, label, tl, ul = args
    cells = int((tl.long() * (ul.long() + 1)).sum())
    src = "e2e_asr_tpu_torch/csrc/transducer.cu"
    loss, _ = rnnt_kernel.transducer_fwd(*args)
    want, alpha = rnnt_kernel.transducer_fwd_reference(*args)
    abs_err = float((loss - want).abs().max())
    rel_err = float(((loss - want).abs() / want.abs()).max())
    if not rel_err <= TOL["transducer_fwd"]:
        fail(f"transducer_fwd disagrees with its plain version: relative "
             f"{rel_err} (absolute {abs_err})")
    lens = nbytes(tl, ul)
    record.add(
        "transducer_fwd", src, "e2e_asr_tpu/ops/transducer_pallas.py:154 "
        "(_fwd_call :139, body _fwd_kernel :101)", abs_err,
        f"max_rel_err={rel_err:.3e} tolerance={TOL['transducer_fwd']:.0e} "
        f"(relative, per example) B={RNNT_B} T={RNNT_T} U={RNNT_U} "
        f"cells={cells}",
        time_ms(lambda: rnnt_kernel.transducer_fwd(*args), 50),
        time_ms(lambda: rnnt_kernel.transducer_fwd_reference(*args), 3,
                warmup=1),
        (8 * cells, 3 * 4 * cells + lens + nbytes(loss)), None)
    ones = torch.ones(RNNT_B, device=dev)
    f64 = [arg.double() for arg in args[:2]] + args[2:]
    loss64, alpha64 = rnnt_kernel.transducer_fwd_reference(*f64)
    exact = rnnt_kernel.transducer_bwd_reference(*f64, alpha64, loss64,
                                                 ones.double())
    loss_k, alpha_k = rnnt_kernel.transducer_fwd(*args)
    chains = {"kernel": rnnt_kernel.transducer_bwd(*args, alpha_k, loss_k,
                                                   ones),
              "plain": rnnt_kernel.transducer_bwd_reference(
                  *args, alpha, want, ones)}
    f64_err = {k: max(float((x.double() - e).abs().max())
                      for x, e in zip(v, exact)) for k, v in chains.items()}
    print(f"transducer_bwd at g=1 against float64: kernels' chain "
          f"{f64_err['kernel']:.3e}, plain float32 chain "
          f"{f64_err['plain']:.3e}", flush=True)
    g = torch.full((RNNT_B,), 1.0 / RNNT_B, device=dev)
    record("transducer_bwd", src, "e2e_asr_tpu/ops/transducer_pallas.py:211 "
           "(_bwd_call :202, body _bwd_kernel :172)",
           rnnt_kernel.transducer_bwd(*args, alpha, want, g),
           rnnt_kernel.transducer_bwd_reference(*args, alpha, want, g),
           lambda: rnnt_kernel.transducer_bwd(*args, alpha, want, g),
           lambda: rnnt_kernel.transducer_bwd_reference(*args, alpha, want,
                                                        g),
           50, 3, (20 * cells, 3 * 4 * cells + lens + nbytes(want, g, blank,
                                                               label)),
           grad_err_vs_f64=f64_err["kernel"],
           plain_grad_err_vs_f64=f64_err["plain"])


def serve_transducer(dev, card, rev_vocab) -> dict:
    """Phase 11e: the flagship transducer (random weights from seed 0)
    serves phase 4's 24 requests (beam 4); then one batch of 8 decoded on
    the card and on the CPU, greedily and by beam 4, must give identical
    token rows. Returns the serving run's launches."""
    cfg = transducer_cfg()
    params = step.init_params(torch.Generator().manual_seed(0), cfg,
                              device=dev)
    with torch.no_grad():
        zero_launches()
        feats, texts, stats = serve(params, cfg, dev, rev_vocab)
        launches = read_launches("serving transducer", ("lstm_bidir",))
        if any(launches[k] for k in ATTENTION_DECODE + TRANSDUCER_PATH):
            fail("transducer serving launched a kernel off its route")
        print(f"serving transducer ({card}): {json.dumps(stats)}")
        print(f"first transcripts: {[t[:60] for t in texts[:3]]}")
        if len(texts) != 24 or not all(isinstance(t, str) for t in texts):
            fail("not every request got a transcript")
        reqs = feats[:8]
        T = max(x.shape[0] for x in reqs)
        bucket = next(b for b in (128, 256, 512) if T <= b)
        batch = {"logmel": np.zeros((8, bucket, cfg.feat_length),
                                    np.float32),
                 "logmel_len": np.array([x.shape[0] for x in reqs])}
        for i, x in enumerate(reqs):
            batch["logmel"][i, :x.shape[0]] = x
        cpu_params = to_device(params, "cpu")
        for k in (1, 4):
            decode = transducer_beam.make_decoder(cfg, BeamConfig(
                beam_size=k))
            t0 = time.monotonic()
            card_run = [x.cpu() for x in decode(params, batch)]
            torch.cuda.synchronize()
            t1 = time.monotonic()
            cpu_run = decode(cpu_params, batch)
            t2 = time.monotonic()
            same = int((card_run[0] == cpu_run[0]).all(dim=1).sum())
            score_err = float((card_run[2] - cpu_run[2]).abs().max())
            print(f"transducer decode beam {k}, batch of 8: card vs CPU "
                  f"{same}/8 rows identical, {int(card_run[1].sum())} "
                  f"tokens, max score difference {score_err:.3e}; card "
                  f"{t1 - t0:.3f} s, CPU {t2 - t1:.3f} s", flush=True)
            if same != 8:
                fail(f"transducer beam {k}: the card's and the CPU's "
                     "decodes differ")
    return launches


def transducer_entry_points(dev, card) -> dict:
    """Phase 11d: `cli.main -model_family transducer` at the flagship
    widths on phase 7's corpus shape (64 training, 8 dev and 8 test
    utterances): it trains 2 steps at a batch of 32 (#17 both ways, a
    greedy dev evaluation, a save); `-dev` greedily and at beam 4; `-test
    -beam_size 4`. Each run counts from zero, launches no attention-decoder
    kernel, and writes its files. Returns the launches of each run."""
    runs = {}
    with tempfile.TemporaryDirectory() as root:
        vocab, data = os.path.join(root, "vocab"), os.path.join(root, "data")
        synth.make_vocab_dir(vocab)
        os.makedirs(data)
        utt = dict(feat_length=80, min_tokens=24, max_tokens=47,
                   frames_per_token=8)
        for name, n, seed in (("train_1k.0.0001", 64, 3), ("dev.0001", 8, 4),
                              ("eval2000.0001", 8, 5)):
            synth.write_speech_corpus(os.path.join(data, name), n, seed=seed,
                                      **utt)
        base = ["-data_dir", data, "-vocab_dir", vocab, "-tb_dir",
                os.path.join(root, "models"), "-steps_per_checkpoint", "2",
                "-max_epochs", "0", "-compute_dtype", "float32",
                "-model_family", "transducer"]
        cfg = cli.parse_options(base + ["-dev"])
        best, train_dir = cfg.train.best_model_dir, cfg.train.train_dir
        for name, argv, required, out in (
                ("cli transducer train", ["-buck_batch_sizes", "32"],
                 TRANSDUCER_RECIPE_PATH, None),
                ("cli transducer -dev greedy",
                 ["-dev", "-buck_batch_sizes", "32"], ("lstm_bidir",),
                 "decoded_asr.txt"),
                ("cli transducer -dev beam 4",
                 ["-dev", "-beam_size", "4", "-buck_batch_sizes", "8"],
                 ("lstm_bidir",), "decoded_asr.txt"),
                ("cli transducer -test beam 4", ["-test", "-beam_size", "4"],
                 ("lstm_bidir",), "decoded_asr.txt")):
            zero_launches()
            t0 = time.monotonic()
            cli.main(base + argv)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            counts = read_launches(name, required)
            off = ATTENTION_DECODE + (() if out is None else TRANSDUCER_PATH)
            if any(counts[k] for k in off):
                fail(f"the {name} run launched a kernel off its route")
            if out is None:
                if not checkpoint.latest_path(train_dir):
                    fail("cli transducer train wrote no checkpoint")
            else:
                with open(os.path.join(best, out)) as f:
                    if len(f.read().splitlines()) != 8:
                        fail(f"{name}: not 8 hypotheses")
                os.remove(os.path.join(best, out))
            print(f"{name} ({card}): wall {wall:.3f} s", flush=True)
            runs[name] = counts
    return runs


def check_ctc_prefix(dev, record: Recorder) -> None:
    """Phase 3, kernel #16 (CTC_PREFIX_CASES): each case's scan inputs as
    CTCPrefixScorer.scan_inputs gathers them from random CTC logits
    (ragged lengths), fresh and mid-decode; psi, rn and rb against the
    plain version on the same CUDA tensors. Times at the serving shape.
    Bound: its inputs read once and outputs written once at 3.35 TB/s
    (about 29 float32 operations a chain-frame: three lse and two adds,
    far below); no PyTorch call computes this recurrence: library none."""
    worst = 0.0
    for i, (B, k, T, V, pre) in enumerate(CTC_PREFIX_CASES):
        rng = np.random.default_rng(16 + i)
        lens = torch.tensor(rng.integers(T // 2, T + 1, size=B), device=dev)
        lens[0] = T
        scorer = CTCPrefixScorer(torch.tensor(
            rng.normal(size=(B, T, V)).astype(np.float32) * 2, device=dev),
            lens, pre_beam=pre)
        mid = scorer.init_state(k)
        mid["rn"] = torch.tensor(rng.normal(size=(B, k, T)).astype(
            np.float32) * 5 - 20, device=dev)
        mid["rn"][:, -1] = ctc_prefix.NEG_INF
        mid["last"] = torch.tensor(rng.integers(-1, V, size=(B, k)),
                                   dtype=torch.int32, device=dev)
        att = torch.tensor(rng.normal(size=(B, k, V)).astype(np.float32),
                           device=dev)
        for state in (scorer.init_state(k), mid):
            _, args = scorer.scan_inputs(state, att)
            got = ctc_prefix.prefix_scan(*args)
            want = ctc_prefix.prefix_scan_reference(*args)
            torch.cuda.synchronize()
            for name, g, w in zip(("psi", "rn", "rb"), got, want):
                neg = w < ctc_prefix.NEG_INF / 2
                if not torch.equal(g < ctc_prefix.NEG_INF / 2, neg):
                    fail(f"ctc_prefix {name} (case {i}): NEG_INF entries "
                         "differ from the plain version's")
                err = float(((g - w).abs() / w.abs().clamp_min(1.0))[~neg]
                            .max())
                if not err <= TOL["ctc_prefix"]:
                    fail(f"ctc_prefix {name} (case {i}) disagrees with its "
                         f"plain version: {err}")
                worst = max(worst, err)
                if i == 0 and state is mid:
                    abs_err = float((g - w).abs()[~neg].max())
                    serving = (args, got)
        print(f"ctc_prefix case B={B} k={k} T={T} P="
              f"{args[0].shape[-1]}: within {TOL['ctc_prefix']:.0e}",
              flush=True)
    args, got = serving
    T, BK, P = args[0].shape
    record.add(
        "ctc_prefix", "e2e_asr_tpu_torch/csrc/ctc_prefix.cu",
        "e2e_asr_tpu/ops/ctc_prefix_pallas.py:111 (prefix_scan :86, body "
        "_kernel :51)", abs_err,
        f"max_rel_err={worst:.3e} tolerance={TOL['ctc_prefix']:.0e} "
        f"(relative to max(|x|, 1), every case; NEG_INF entries by the "
        f"NEG_INF/2 threshold) T={T} BK={BK} P={P}",
        time_ms(lambda: ctc_prefix.prefix_scan(*args), 200),
        time_ms(lambda: ctc_prefix.prefix_scan_reference(*args), 3,
                warmup=1),
        (29 * T * BK * P, nbytes(*args, *got)), None)


def ctc_entry_points(dev, card) -> dict:
    """Phase 12d: the command line at the flagship widths on phase 7's
    corpus shape (64 training, 8 dev and 8 test utterances). `-ctc_weight
    0.3` trains 2 steps at a batch of 32 (A, #8/#9, a greedy dev
    evaluation, a save), then `-dev -beam_size 4 -joint_ctc 0.3` at a
    batch of 1 and of 64 (joint beams: #16 launched, #15 not) and `-test
    -beam_size 4 -joint_ctc 0.3`; `-model_family ctc` trains 2 steps, then
    `-dev` greedily and at beam 4 (no decoder kernel). Each run counts from
    zero and writes its files. Returns the launches of each run."""
    runs = {}
    with tempfile.TemporaryDirectory() as root:
        vocab, data = os.path.join(root, "vocab"), os.path.join(root, "data")
        synth.make_vocab_dir(vocab)
        os.makedirs(data)
        utt = dict(feat_length=80, min_tokens=24, max_tokens=47,
                   frames_per_token=8)
        for name, n, seed in (("train_1k.0.0001", 64, 3), ("dev.0001", 8, 4),
                              ("eval2000.0001", 8, 5)):
            synth.write_speech_corpus(os.path.join(data, name), n, seed=seed,
                                      **utt)
        common = ["-data_dir", data, "-vocab_dir", vocab, "-tb_dir",
                  os.path.join(root, "models"), "-steps_per_checkpoint", "2",
                  "-max_epochs", "0", "-compute_dtype", "float32",
                  "-lm_prob", "0"]
        joint = ["-beam_size", "4", "-joint_ctc", str(JOINT_CTC)]
        decode_only = ("lstm_bidir_train", "lstm_bidir_bwd", "dec_train_fwd",
                       "dec_train_bwd", "beam_mega")
        train_path = TRAIN_PATH + ("lstm_bidir", "cells_fused",
                                   "output_fused")
        for family, flags, steps in (
                ("hybrid", ["-ctc_weight", str(JOINT_CTC)], (
                    ("train", ["-buck_batch_sizes", "32"], train_path,
                     ("beam_mega", "ctc_prefix", "beam_select"), None),
                    ("-dev joint beam 4 batch 1",
                     ["-dev", *joint, "-buck_batch_sizes", "1"], JOINT_PATH,
                     decode_only, "raw_4.txt"),
                    ("-dev joint beam 4 batch 64",
                     ["-dev", *joint, "-buck_batch_sizes", "64"], JOINT_PATH,
                     decode_only, "raw_4.txt"),
                    ("-test joint beam 4", ["-test", *joint], JOINT_PATH,
                     decode_only, "raw_4.txt"))),
                ("ctc", ["-model_family", "ctc"], (
                    ("train", ["-buck_batch_sizes", "32"], CTC_RECIPE_PATH,
                     ATTENTION_DECODE, None),
                    ("-dev greedy", ["-dev", "-buck_batch_sizes", "32"],
                     ("lstm_bidir",), ATTENTION_DECODE + CTC_PATH,
                     "decoded_asr.txt"),
                    ("-dev beam 4", ["-dev", "-beam_size", "4",
                                     "-buck_batch_sizes", "8"],
                     ("lstm_bidir",), ATTENTION_DECODE + CTC_PATH,
                     "decoded_asr.txt")))):
            base = common + flags
            cfg = cli.parse_options(base + ["-dev"])
            best, train_dir = cfg.train.best_model_dir, cfg.train.train_dir
            for what, argv, required, forbidden, out in steps:
                name = f"cli {family} {what}"
                zero_launches()
                t0 = time.monotonic()
                cli.main(base + argv)
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
                counts = read_launches(name, required)
                if any(counts[k] for k in forbidden):
                    fail(f"the {name} run launched a kernel off its route")
                if out is None:
                    named, _ = checkpoint.restore_latest(train_dir)
                    if "params/ctc_head/kernel" not in named:
                        fail(f"{name} saved no CTC head")
                else:
                    with open(os.path.join(best, out)) as f:
                        if len(f.read().splitlines()) != 8:
                            fail(f"{name}: not 8 hypotheses")
                    os.remove(os.path.join(best, out))
                print(f"{name} ({card}): wall {wall:.3f} s, #16 launches "
                      f"{counts['ctc_prefix']}", flush=True)
                runs[name] = counts
    return runs


def serve_ctc_families(dev, card, rev_vocab) -> dict:
    """Phase 12e: the flagship hybrid (random weights from seed 0) serves
    phase 4's 24 requests by joint CTC/attention beams (beam 4, joint
    0.3: #16 every step, no #15), and one batch of 8 decoded on the card
    and on the CPU agrees up to near-ties, as phase 4's; then the CTC
    family's burst at beam 1 (best path) and 4 (prefix beam search), and
    its batch of 8 decoded on the card and on the CPU with identical rows.
    Returns the launches of each burst."""
    runs = {}
    joint = BeamConfig(beam_size=4, max_steps=120, joint_ctc=JOINT_CTC)
    for family, cfg, beams in (
            ("hybrid", hybrid_cfg(40, None), (joint,)),
            ("ctc", ctc_cfg(), (BeamConfig(beam_size=1),
                                BeamConfig(beam_size=4)))):
        params = step.init_params(torch.Generator().manual_seed(0), cfg,
                                  device=dev)
        for bc in beams:
            name = f"serving {family} beam {bc.beam_size}"
            with torch.no_grad():
                zero_launches()
                feats, texts, stats = serve(params, cfg, dev, rev_vocab, bc)
                launches = read_launches(name, JOINT_PATH if family ==
                                         "hybrid" else ("lstm_bidir",))
                off = (("beam_mega",) if family == "hybrid"
                       else ATTENTION_DECODE)
                if any(launches[k] for k in off):
                    fail(f"{name} launched a kernel off its route")
                print(f"{name} ({card}): {json.dumps(stats)}; #16 launches "
                      f"{launches['ctc_prefix']}", flush=True)
                if len(texts) != 24 or not all(isinstance(t, str)
                                                for t in texts):
                    fail("not every request got a transcript")
                runs[name] = launches
                if family == "hybrid":
                    compare_cpu(params, cfg, feats, bc)
                    continue
                batch = serving_batch(cfg, feats)
                decode = ctc_beam.make_decoder(cfg, bc)
                t0 = time.monotonic()
                card_run = [x.cpu() for x in decode(params, batch)]
                t1 = time.monotonic()
                cpu_run = decode(to_device(params, "cpu"), batch)
                same = int((card_run[0] == cpu_run[0]).all(dim=1).sum())
                print(f"ctc decode beam {bc.beam_size}, batch of 8: card vs "
                      f"CPU {same}/8 rows identical, "
                      f"{int(card_run[1].sum())} tokens, max score "
                      f"difference "
                      f"{float((card_run[2] - cpu_run[2]).abs().max()):.3e}; "
                      f"card {t1 - t0:.3f} s, CPU {time.monotonic() - t1:.3f}"
                      " s", flush=True)
                if same != 8:
                    fail(f"ctc beam {bc.beam_size}: the card's and the "
                         "CPU's decodes differ")
    return runs


def ctc_families(dev, card, rev_vocab) -> dict:
    """Phase 12: the hybrid CTC/attention family and the CTC family at
    the flagship widths. Returns the launches of each main-path run."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import prof_port
    paths = {}
    for name, cfg in (("hybrid", hybrid_cfg()), ("ctc", ctc_cfg())):
        shapes = step.init_params(torch.Generator(), cfg, device="meta")
        print(f"{name} model: {seq2seq.param_count(shapes)} parameters")
    # (a) the hybrid step (char + phone, ctc_weight 0.3)
    paths["hybrid"] = train(hybrid_cfg(), dev, card, TRAIN_PATH,
                            "hybrid training (-ctc_weight 0.3, char + phone)")
    prof_port.profile_train(hybrid_cfg(), dev, "hybrid_step")
    # (b) the CTC family's step
    paths["ctc"] = train(ctc_cfg(), dev, card, CTC_PATH,
                         "ctc training (-model_family ctc)")
    if any(paths["ctc"][k] for k in ("dec_train_fwd", "dec_train_bwd")):
        fail("the CTC step launched a decoder kernel")
    prof_port.profile_train(ctc_cfg(), dev, "ctc_step")
    # (c) the Trainers
    paths.update(recipe(dev, card, "hybrid"))
    paths.update(recipe(dev, card, "ctc"))
    # (d) the command line, (e) serving
    paths.update(ctc_entry_points(dev, card))
    paths.update(serve_ctc_families(dev, card, rev_vocab))
    prof_port.profile_joint_decode(dev)
    return paths


DEEP_FLAGS = ["-num_layers_dec", "2", "-lm_hsize", str(WIDE_LM),
              "-ind_softmax"]


def deep_entry_points(dev, card) -> dict:
    """Phase 13d: the command line with DEEP_FLAGS at the flagship widths
    on phase 7's corpus shape (64 training, 8 dev, 8 test utterances),
    for LSTM cells and `-gru`: `cli.main` trains 2 steps (greedy dev
    evaluation, save) in its char_dec_dep_2_ run directory; `-dev
    -beam_size 4 -buck_batch_sizes 1`: one #15 launch per utterance and no
    per-step kernel; `-test -beam_size 4` at a batch of 64: the per-step
    route and no #15. Returns the launches of each run."""
    runs = {}
    with tempfile.TemporaryDirectory() as root:
        vocab, data = os.path.join(root, "vocab"), os.path.join(root, "data")
        synth.make_vocab_dir(vocab)
        os.makedirs(data)
        utt = dict(feat_length=80, min_tokens=24, max_tokens=47,
                   frames_per_token=8)
        for name, n, seed in (("train_1k.0.0001", 64, 3), ("dev.0001", 8, 4),
                              ("eval2000.0001", 8, 5)):
            synth.write_speech_corpus(os.path.join(data, name), n, seed=seed,
                                      **utt)
        base = ["-data_dir", data, "-vocab_dir", vocab, "-tb_dir",
                os.path.join(root, "models"), "-steps_per_checkpoint", "2",
                "-max_epochs", "0", "-compute_dtype", "float32", *DEEP_FLAGS]
        for cells, extra in (("lstm", []), ("gru", ["-gru"])):
            argv = base + extra
            opts = cli.parse_options(argv + ["-dev"])
            best, train_dir = opts.train.best_model_dir, opts.train.train_dir
            if "char_dec_dep_2_" not in train_dir:
                fail(f"the deep run directory is {train_dir}")
            gru = cells == "gru"
            enc = ("gru_bidir",) if gru else ("lstm_bidir",)
            cells_row, mega = decode_rows(gru)
            per_step = (cells_row, "output_fused", "beam_select")
            train_path = GRU_TRAIN_PATH if gru else TRAIN_PATH
            label = f"cli deep {cells}"
            for name, flags, required, forbidden, n_mega in (
                    ("train", ["-buck_batch_sizes", "32"],
                     train_path + enc + (cells_row, "output_fused"),
                     (mega,), 0),
                    ("-dev beam 4 batch 1", ["-dev", "-beam_size", "4",
                                             "-buck_batch_sizes", "1"],
                     enc + (mega,), per_step, 8),
                    ("-test beam 4", ["-test", "-beam_size", "4"],
                     enc + per_step, (mega,), 0)):
                zero_launches()
                t0 = time.monotonic()
                cli.main(argv + flags)
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
                counts = read_launches(f"{label} {name}", required)
                if any(counts[k] for k in forbidden) or counts[mega] != n_mega:
                    fail(f"{label} {name}: {counts[mega]} #15 launches, not "
                         f"{n_mega}, or a kernel of {forbidden} launched")
                if name == "train":
                    depths = (dec_train_gru if gru else dec_train).DEPTHS
                    if set(depths) != {2}:      # the char decoder alone
                        fail(f"{label} train: decoder depths {depths}")
                    if not checkpoint.latest_path(train_dir):
                        fail(f"{label} train wrote no checkpoint")
                else:
                    with open(os.path.join(best, "raw_4.txt")) as f:
                        if len(f.read().splitlines()) != 8:
                            fail(f"{label} {name}: not 8 hypotheses")
                print(f"{label} {name} ({card}): wall {wall:.3f} s",
                      flush=True)
                runs[f"{label} {name}"] = counts
    return runs


def deep_decoders(dev, card, rev_vocab) -> dict:
    """Phase 13: deep_cfg (the char decoder two layers deep, 1280-wide LM
    cells through SimpleProjection, ind_softmax). (a) one char + phone
    asr_step at B=16 on the card and on the CPU, LSTM and `-gru`, and one
    LM step at H=1280, must agree (phase 5's tolerances); (b) three
    asr_steps at B=128, T=384, L=48 and three LM steps at B=128, T=120:
    every loss finite, #4's training form, #5's wide form and #8/#9 at
    depths 2 (char) and 1 (phone) launched, #3 and #5 not; their times,
    frames/s and tokens/s; the step's device split (tools/prof_port.py);
    (c) the Trainer on phase 6's corpus with the LM task, and its resume;
    (d) the command line (deep_entry_points); (e) phase 4's serving burst
    on the deep model, and one batch decoded on the card equal to the
    CPU's up to near-ties. Returns the launches of each main-path run."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import prof_port
    paths = {}
    cfg = deep_cfg()
    shapes = step.init_params(torch.Generator(), cfg, device="meta")
    print(f"deep model: {seq2seq.param_count(shapes)} parameters")
    lm_cfg = LMConfig(vocab_size=40, lm_hidden_size=WIDE_LM)
    compare_train_step(cfg, dev, lm_cfg)
    compare_train_step(deep_cfg("gru"), dev, lm_cfg)
    paths["deep"] = train_lm_multitask(dev, card, cfg, DEEP_LM_PATH,
                                       "deep decoders")
    prof_port.profile_train(cfg, dev, "deep_step")
    paths.update(recipe(dev, card, "deep"))
    paths.update(deep_entry_points(dev, card))
    params = seq2seq.init(torch.Generator().manual_seed(0), cfg, device=dev)
    with torch.no_grad():
        zero_launches()
        feats, texts, stats = serve(params, cfg, dev, rev_vocab)
        paths["serving deep"] = read_launches("serving deep", SERVING_PATH)
        print(f"serving deep ({card}): {json.dumps(stats)}")
        if len(texts) != 24 or not all(isinstance(t, str) for t in texts):
            fail("not every request to the deep model got a transcript")
        compare_cpu(params, cfg, feats)
    return paths


def check_mhsa(dev, record: Recorder) -> None:
    """Phase 14a: kernel #18 against its plain version at MHSA_CASES, in
    both forms: the out-only form (the encoder's inference call; row
    `name`) beside scaled_dot_product_attention on the same out (its
    additive mask the relmat plus the padding bias; it computes out alone),
    and the probs form (row `name`_probs) beside the plain chain; the
    out-only form's out must be the probs form's, bit for bit. Times are
    device times a call from a CUDA graph of 50 calls (graph_ms), so that
    the host does not set them. The bound of each form: q, k, v, the biases
    read once, out (and probs) written once; the two matmuls' and the
    softmax's float32 operations."""
    rng = np.random.default_rng(18)
    nh, hd = 4, 128
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, B, T, rel in MHSA_CASES:
        def rand(*shape, scale=1.0):
            return torch.tensor((rng.normal(size=shape) * scale).astype(
                np.float32), device=dev)

        q, k, v = (rand(B, nh, T, hd) for _ in range(3))
        lens = rng.integers(1, T + 1, size=B)
        lens[0], lens[-1] = T, 0
        pad = torch.tensor(np.where(np.arange(T)[None, :] < lens[:, None],
                                    0.0, -1e30).astype(np.float32),
                           device=dev)
        relmat = (rand(nh, T, T, scale=0.3) if rel
                  else torch.zeros(nh, T, T, device=dev))
        args = (q, k, v, pad, relmat)
        got = mhsa.attend(*args, return_probs=True)
        only = mhsa.attend(*args)
        want = mhsa.attend_reference(*args)
        if not torch.equal(only, got[0]):
            fail(f"{name}: the out-only form's out is not the probs form's")
        uniform = torch.full_like(got[1][-1], 1.0 / T)
        if float((got[1][-1] - uniform).abs().max()) > 1e-7:
            fail(f"{name}: the zero-length row's probs are not uniform")
        mask = (relmat[None] + pad[:, None, None, :]).contiguous()
        lib_err = float((sdpa(q, k, v, attn_mask=mask) - want[0])[:-1]
                        .abs().max())
        print(f"{name}: scaled_dot_product_attention vs the plain version "
              f"on the rows of nonzero length: {lib_err:.3e}", flush=True)
        flops = 4 * B * nh * T * T * hd + 8 * B * nh * T * T

        def route():
            p = mhsa.LAST_PLAN
            return f"{p['route']}, {p['rows']} query rows a block"

        src = "e2e_asr_tpu_torch/csrc/mhsa.cu"
        replaces = "e2e_asr_tpu/ops/mhsa_pallas.py:116"
        record(name, src, replaces, [only], want[:1],
               lambda: mhsa.attend(*args),
               lambda: mhsa.attend_reference(*args), 50, 50,
               (flops, nbytes(*args, only)),
               library=lambda: graph_ms(
                   lambda: sdpa(q, k, v, attn_mask=mask), 50),
               route=route, timer=graph_ms)
        record(f"{name}_probs", src, replaces, got, want,
               lambda: mhsa.attend(*args, return_probs=True),
               lambda: mhsa.attend_reference(*args), 50, 50,
               (flops, nbytes(*args, *got)), route=route, timer=graph_ms)


class mhsa_gate:
    """E2E_ASR_MHSA_KERNEL set (on) or unset (off) inside the block, the
    caller's value restored after it."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.saved = os.environ.pop("E2E_ASR_MHSA_KERNEL", None)
        if self.on:
            os.environ["E2E_ASR_MHSA_KERNEL"] = "1"

    def __exit__(self, *exc):
        os.environ.pop("E2E_ASR_MHSA_KERNEL", None)
        if self.saved is not None:
            os.environ["E2E_ASR_MHSA_KERNEL"] = self.saved


def xfmr_entry_points(dev, card) -> dict:
    """Phase 14e: `cli.main` with XFMR_FLAGS at the flagship's decoders on
    phase 7's corpus shape (64 training, 8 dev, 8 test utterances), with
    E2E_ASR_MHSA_KERNEL set: trains 2 steps (the xfmr_4h_ run directory;
    its greedy dev evaluation launches #18), `-dev -beam_size 4
    -buck_batch_sizes 1` (one #15 launch an utterance) and `-test
    -beam_size 4` at 64 (the per-step route). Every run launches #18 and
    no recurrent encoder kernel. Returns the launches of each run."""
    runs = {}
    with tempfile.TemporaryDirectory() as root, mhsa_gate(True):
        vocab, data = os.path.join(root, "vocab"), os.path.join(root, "data")
        synth.make_vocab_dir(vocab)
        os.makedirs(data)
        utt = dict(feat_length=80, min_tokens=24, max_tokens=47,
                   frames_per_token=8)
        for name, n, seed in (("train_1k.0.0001", 64, 3), ("dev.0001", 8, 4),
                              ("eval2000.0001", 8, 5)):
            synth.write_speech_corpus(os.path.join(data, name), n, seed=seed,
                                      **utt)
        argv = ["-data_dir", data, "-vocab_dir", vocab, "-tb_dir",
                os.path.join(root, "models"), "-steps_per_checkpoint", "2",
                "-max_epochs", "0", "-compute_dtype", "float32", *XFMR_FLAGS]
        opts = cli.parse_options(argv + ["-dev"])
        best, train_dir = opts.train.best_model_dir, opts.train.train_dir
        if not os.path.basename(train_dir).startswith("xfmr_4h_"):
            fail(f"the transformer run directory is {train_dir}")
        per_step = ("cells_fused", "output_fused", "beam_select")
        for name, flags, required, forbidden, n_mega in (
                ("train", ["-buck_batch_sizes", "32"],
                 XFMR_TRAIN_PATH + ("mhsa", "cells_fused", "output_fused"),
                 ("beam_mega",), 0),
                ("-dev beam 4 batch 1", ["-dev", "-beam_size", "4",
                                         "-buck_batch_sizes", "1"],
                 ("mhsa", "beam_mega"), per_step, 8),
                ("-test beam 4", ["-test", "-beam_size", "4"],
                 ("mhsa",) + per_step, ("beam_mega",), 0)):
            label = f"cli transformer {name}"
            zero_launches()
            t0 = time.monotonic()
            cli.main(argv + flags)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            counts = read_launches(label, required)
            if (any(counts[k] for k in forbidden + RECURRENT_ENCODER)
                    or counts["beam_mega"] != n_mega):
                fail(f"{label}: {counts['beam_mega']} #15 launches, not "
                     f"{n_mega}, or a kernel of {forbidden} or a recurrent "
                     "encoder's launched")
            if name == "train":
                if not checkpoint.latest_path(train_dir):
                    fail(f"{label} wrote no checkpoint")
            else:
                with open(os.path.join(best, "raw_4.txt")) as f:
                    if len(f.read().splitlines()) != 8:
                        fail(f"{label}: not 8 hypotheses")
            print(f"{label} ({card}): wall {wall:.3f} s, #18 launches "
                  f"{counts['mhsa']}", flush=True)
            runs[label] = counts
    return runs


def xfmr_gate_runs(dev, card, rev_vocab) -> dict:
    """Phase 14f: phase 4's serving burst on the transformer model (random
    weights from seed 0) with the #18 gate on and then off: the gated burst
    launches #18, the other not; every request gets a transcript. Its
    three batches of 8 (in request order, each padded to its bucket) are
    decoded with the gate on and off and must agree up to near-ties (as
    phase 4); so must one batch of the second form (rel_pos_bias with a
    random table, conv kernel 15), whose encoder feeds #18's relmat input.
    Returns the launches of the gated burst."""
    cfg = transformer_cfg(phone_vocab=None)
    params = seq2seq.init(torch.Generator().manual_seed(0), cfg, device=dev)
    decode = beam_eval.make_beam_decoder(
        cfg, BeamConfig(beam_size=4, max_steps=120))
    runs, texts = {}, {}
    with torch.no_grad():
        for on in (True, False):
            with mhsa_gate(on):
                zero_launches()
                feats, texts[on], stats = serve(params, cfg, dev, rev_vocab)
                label = f"serving transformer, #18 gate {'on' if on else 'off'}"
                counts = read_launches(label, SERVING_PATH[1:]
                                       + (("mhsa",) if on else ()))
                if (not on and counts["mhsa"]) or any(
                        counts[k] for k in RECURRENT_ENCODER):
                    fail(f"{label} launched #18 or a recurrent encoder")
                print(f"{label} ({card}): {json.dumps(stats)}", flush=True)
                if len(texts[on]) != 24 or not all(
                        isinstance(x, str) for x in texts[on]):
                    fail(f"{label}: not every request got a transcript")
                if on:
                    runs[label] = counts
        same = sum(a == b for a, b in zip(texts[True], texts[False]))
        print(f"serving transformer: {same}/24 transcripts identical with "
              "the #18 gate on and off", flush=True)
        second = transformer_cfg(phone_vocab=None, rel=True, conv=15)
        sparams = seq2seq.init(torch.Generator().manual_seed(1), second,
                               device=dev)
        for i in range(1, 5):
            sparams["encoder"][f"block_{i}"]["rel_bias"].normal_(0, 0.5)
        for what, model, p, reqs in (
                [("burst", cfg, params, feats[i:i + 8]) for i in (0, 8, 16)]
                + [("rel + conv 15", second, sparams, feats[:8])]):
            dec = decode if model is cfg else beam_eval.make_beam_decoder(
                model, BeamConfig(beam_size=4, max_steps=120))
            batch = serving_batch(model, reqs)
            out = {}
            for on in (True, False):
                with mhsa_gate(on):
                    before = mhsa.LAUNCHES
                    out[on] = recorded_selections(
                        lambda: dec(p, batch))
                    if (mhsa.LAUNCHES > before) != on:
                        fail(f"{what}: #18 launched {mhsa.LAUNCHES - before}"
                             f" times with the gate {on}")
            hold_beam_runs(f"transformer {what} (T={batch['logmel'].shape[1]})"
                           " #18 gate on vs off", out[True], out[False],
                           model.decoders["char"].vocab_size)
    return runs


def transformer_family(dev, card, rev_vocab, record: Recorder) -> dict:
    """Phase 14: the transformer encoder family (transformer_cfg): (a) #18
    against its plain version (check_mhsa); (b) one char + phone asr_step
    at B=16 on the card and on the CPU, for the plain form and the rel +
    conv-15 form, must agree (phase 5's tolerances); (c) three steps of
    each at B=128, T=384, L=48: every loss finite, #8/#9 launched, #18 and
    kernel A not; their times and frames/s, and the plain form's device
    split (tools/prof_port.py: matmuls, the attention chain, the rest);
    (d) the Trainer on phase 6's corpus with the LM task (train, greedy dev
    WER, save, exact resume); (e) the command line with the gate
    (xfmr_entry_points); (f) the burst with the gate on and off
    (xfmr_gate_runs). Returns the launches of each main-path run."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import prof_port
    t0 = time.monotonic()
    with torch.no_grad():
        check_mhsa(dev, record)
    paths = {}
    cfg = transformer_cfg()
    shapes = step.init_params(torch.Generator(), cfg, device="meta")
    print(f"transformer model: {seq2seq.param_count(shapes)} parameters, "
          f"encoder {seq2seq.param_count(shapes['encoder'])}")
    with mhsa_gate(False):
        for label, model in (("transformer training", cfg),
                             ("transformer training (rel + conv 15)",
                              transformer_cfg(rel=True, conv=15))):
            paths[label] = train(model, dev, card, XFMR_TRAIN_PATH, label)
            if any(paths[label][k] for k in RECURRENT_ENCODER + ("mhsa",)):
                fail(f"{label} launched #18 or a recurrent encoder's kernel")
        prof_port.profile_train(cfg, dev, "transformer_step")
        paths.update(recipe(dev, card, "transformer"))
    paths.update(xfmr_entry_points(dev, card))
    paths.update(xfmr_gate_runs(dev, card, rev_vocab))
    print(f"phase 14 (the transformer family) took "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    return paths


def main() -> int:
    t_start = time.monotonic()
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

    # 2. build (and tools/ on the path: tools/prof_port.py's profiler split)
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
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
    check_dec_train(params, cfg, dev, record, seed=3)
    check_lm_kernels(params, cfg, dev, record)
    check_mega(params, cfg, dev, record)
    gru_cfg = flagship_cfg(40, PHONE_VOCAB, "gru")
    gru_params = seq2seq.init(torch.Generator().manual_seed(0), gru_cfg,
                              device=dev)
    check_gru_kernels(gru_params, gru_cfg, dev, record)
    check_dec_train(gru_params, gru_cfg, dev, record, seed=14)
    check_dec_train(gru_params, gru_cfg, dev, record, seed=14, task="phone",
                    suffix="_phone")
    with torch.no_grad():
        check_cells_gru(gru_params, gru_cfg, dev, record)
        check_attn_output(params, cfg, gru_params, gru_cfg, dev, record)
    check_mega(gru_params, gru_cfg, dev, record, "beam_mega_gru")
    del gru_params
    with torch.no_grad():
        check_transducer_kernels(dev, record)
        check_ctc_prefix(dev, record)
    deep = {cells: deep_cfg(cells) for cells in ("lstm", "gru")}
    for cells, dcfg in deep.items():
        dparams = seq2seq.init(torch.Generator().manual_seed(0), dcfg,
                               device=dev)
        if cells == "lstm":
            check_wide_lstm(dparams, dcfg, dev, record)
            check_mega(dparams, dcfg, dev, record, "beam_mega_deep")
        check_dec_train(dparams, dcfg, dev, record, seed=15,
                        suffix="_deep")
    del dparams

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

    # 11. the transducer family (-model_family transducer): its train step
    # (card vs CPU at B=16, three steps at B=128), the Trainer (train,
    # greedy dev WER, save, resume), the command line, serving
    shapes = step.init_params(torch.Generator(), transducer_cfg(),
                              device="meta")
    print(f"transducer model: {seq2seq.param_count(shapes)} parameters")
    paths["transducer"] = train(transducer_cfg(), dev, card, TRANSDUCER_PATH,
                                "transducer training")
    import prof_port
    prof_port.profile_train(transducer_cfg(), dev, "transducer_step")
    paths.update(recipe(dev, card, "transducer"))
    paths.update(transducer_entry_points(dev, card))
    paths["serving transducer"] = serve_transducer(dev, card, rev_vocab)

    # 12. the CTC family (-model_family ctc) and the hybrid CTC/attention
    # family (-ctc_weight 0.3, decoded by joint beams on #16): steps,
    # Trainers, the command line, serving
    paths.update(ctc_families(dev, card, rev_vocab))

    # 13. the deep decoders (-num_layers_dec 2 -lm_hsize 1280
    # -ind_softmax): steps card vs CPU and at full size with the LM task on
    # #4, the Trainer, the command line (LSTM and -gru), serving
    paths.update(deep_decoders(dev, card, rev_vocab))

    # 14. the transformer encoder family (-encoder_type transformer) with
    # kernel #18: its rows, steps card vs CPU and at full size, the
    # Trainer, the command line and the burst with the #18 gate on and off
    paths.update(transformer_family(dev, card, rev_vocab, record))
    for row in record.rows:
        row["launches"] = sum(p[row["name"]] for p in paths.values())
    print(f"chip_smoke: every phase passed in {time.monotonic() - t_start:.1f}"
          " s, the build included", flush=True)
    print(json.dumps({"kernels": record.rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
