"""Kernel A: forward of one bidirectional LSTM layer, both directions in one
launch (`csrc/lstm_bidir.cu`).

Replaces: e2e_asr_tpu/ops/lstm_pallas.py `lstm_seq_bidir` (forward, without
in-kernel dropout; its backward and the dropout variant are training work).

Bound on the H100: the recurrence. Each of the T steps needs the whole
previous h, so a chain is serial in time, and at the flagship width
(H=256) every step reads all of W_h, [256, 1024] f32 = 1 MiB per direction,
about 2 MFLOP per batch row. W_h is larger than a block's 227 KB of shared
memory, so it is read through L2 every step: the kernel is bound by one SM's
L2 bandwidth, about 1 MiB per step.

Design: one block per chain (batch row x direction, 2B blocks), the time
loop inside the block, h in shared memory and c in registers. Each hidden
unit's four gate columns of W_h are read by 4 threads, each over a quarter
of the reduction depth, so that 4x more loads are in flight; the quarters
meet in shared memory (two __syncthreads per step). The directions and
batch rows are independent chains on separate SMs. Spreading W_h over the
shared memory of a cluster or a cooperative grid (so that no SM rereads it
from L2) is later work.

Semantics kept from the reference: the backward direction runs on the
time-flipped input, where padding leads, and carries its state through steps
whose mask is 0; the outputs are unmasked h, which the caller masks and
flips back (core/rnn.py).
"""
from __future__ import annotations

import torch

from e2e_asr_tpu_torch.core.cells import _lstm_apply_gates
from e2e_asr_tpu_torch.kernels import build

LAUNCHES = 0


def lstm_seq_bidir_reference(x_proj_fw, x_proj_bw, w_h_fw, w_h_bw, mask_bw):
    """Plain PyTorch version of the kernel: same arguments and results."""
    T, B, H4 = x_proj_fw.shape
    H = H4 // 4
    zero = x_proj_fw.new_zeros(B, H)
    c_fw, h_fw, c_bw, h_bw = zero, zero, zero, zero
    out_fw, out_bw = [], []
    for t in range(T):
        h_fw, (c_fw, _) = _lstm_apply_gates(x_proj_fw[t] + h_fw @ w_h_fw,
                                            c_fw, H)
        new_h, (new_c, _) = _lstm_apply_gates(x_proj_bw[t] + h_bw @ w_h_bw,
                                              c_bw, H)
        valid = mask_bw[t]
        c_bw = valid * new_c + (1.0 - valid) * c_bw
        h_bw = valid * new_h + (1.0 - valid) * h_bw
        out_fw.append(h_fw)
        out_bw.append(h_bw)
    return torch.stack(out_fw), torch.stack(out_bw)


def lstm_seq_bidir(x_proj_fw, x_proj_bw, w_h_fw, w_h_bw, mask_bw,
                   drop_seeds=None, bf16_matmul: bool = False,
                   drop_keep: float = 1.0):
    """Both directions of a bidirectional LSTM layer.

    x_proj_fw: [T,B,4H] input projection in natural time order;
    x_proj_bw: [T,B,4H] projection of the time-FLIPPED inputs;
    w_h_fw, w_h_bw: [H,4H] recurrent kernels; mask_bw: [T,B,1] validity of
    the flipped sequence (padding leads). Returns (h_fw [T,B,H] unmasked,
    h_bw_flipped [T,B,H] carry-through), all float32.
    """
    global LAUNCHES
    if drop_seeds is not None or drop_keep < 1.0 or bf16_matmul:
        raise NotImplementedError(
            "lstm_seq_bidir: in-kernel dropout and bf16 matmuls are training "
            "features (ROADMAP.md Queue 2, kernel #2 with the training slice)")
    if x_proj_fw.device.type == "cpu":
        return lstm_seq_bidir_reference(x_proj_fw, x_proj_bw, w_h_fw, w_h_bw,
                                        mask_bw)
    if x_proj_fw.device.type != "cuda":
        raise ValueError(f"lstm_seq_bidir: unsupported device "
                         f"{x_proj_fw.device}")
    dev = x_proj_fw.device
    T, B, H4 = x_proj_fw.shape
    if H4 % 4:
        raise ValueError(f"x_proj last dim {H4} is not 4*H")
    H = H4 // 4
    f32 = torch.float32
    build.require(x_proj_fw, "x_proj_fw", f32, (T, B, H4), dev)
    build.require(x_proj_bw, "x_proj_bw", f32, (T, B, H4), dev)
    build.require(w_h_fw, "w_h_fw", f32, (H, H4), dev)
    build.require(w_h_bw, "w_h_bw", f32, (H, H4), dev)
    build.require(mask_bw, "mask_bw", f32, (T, B, 1), dev)
    h_fw = torch.empty(T, B, H, device=dev)
    h_bw = torch.empty(T, B, H, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.e2e_lstm_bidir_fwd(
            x_proj_fw.data_ptr(), x_proj_bw.data_ptr(), w_h_fw.data_ptr(),
            w_h_bw.data_ptr(), mask_bw.data_ptr(), h_fw.data_ptr(),
            h_bw.data_ptr(), T, B, H, build.stream_ptr(dev))
    build.check(err, "lstm_seq_bidir")
    LAUNCHES += 1
    return h_fw, h_bw
