"""Kernel A: one bidirectional LSTM layer, both directions in one launch
(`csrc/lstm_bidir.cu`), and its backward (`csrc/lstm_bidir_bwd.cu`).

Replaces: e2e_asr_tpu/ops/lstm_pallas.py `lstm_seq_bidir` (forward, without
in-kernel dropout), its residual-saving training form `_lstm_seq_bidir_fwd`
(also writes c), and its backward: `_bwd_seq_bidir` (both directions, one
launch) and `_bwd_seq` (one direction with an optional carry mask).

Bound on the H100: the recurrence. Each of the T steps needs the whole
previous h, so a chain is serial in time, and at the flagship width
(H=256) every step multiplies the rows' h by all of W_h, [256, 1024] f32 =
1 MiB per direction, about 2 MFLOP per batch row.

Design: the forward walks time with a cluster of 8 blocks per group of
batch rows of a direction (20 rows at layer 1; 16 blocks and 4 rows at
the serving shape): each block keeps its own units' gate columns of W_h in
shared memory for the whole walk (the "resident" route, H <= 320) or
streams them in every step (the "streamed" route, wider), gathers h_{t-1}
of every unit from its peers through distributed shared memory,
multiplies, runs the cell with c in registers and publishes its slice of
h_t; one cluster barrier a step. Each gate's sum keeps the depth slices
and order of the one-block chain it replaced, so it gives that chain's
bits.
The CUDA source chooses the route, the cluster size and the rows
(`fwd_plan` reads them); `FWD_ROUTES` counts the routes taken and
`FWD_LAST_PLAN` keeps the plan of the last launch. The backward (see the
CUDA source) computes every step's gate pre-activations in one tiled
product, then walks time in reverse with the same clusters of 8 blocks
(20 rows at layer 1): W_h split over the cluster's shared memory by units
(the "resident" route, H <= 296) or streamed from a re-laid copy each step
(the "streamed" route, wider); each block multiplies its slice of dgates
by its own columns of W_h into a share of dh for every unit, and after one
cluster barrier a step sums its units' shares through distributed shared
memory; dW_h = sum h_{t-1}^T dgates is a tiled reduction over the T*B
rows. `bwd_plan` reads the backward's route and rows; `BWD_ROUTES` counts
them and `BWD_LAST_PLAN` keeps the plan of the last launch.

Semantics kept from the reference: the backward direction runs on the
time-flipped input, where padding leads, and carries its state through steps
whose mask is 0 (its gradient passes dh and dc through those steps); the
outputs are unmasked h, which the caller masks and flips back (core/rnn.py).

Autograd: `lstm_seq_bidir` on inputs that need a gradient runs the training
form inside `_LSTMBidir`, whose backward is the backward kernel on the card
and `lstm_bwd_reference` (the plain version, mirroring `_bwd_seq_xla`) on
the CPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from e2e_asr_tpu_torch.core.cells import _lstm_apply_gates
from e2e_asr_tpu_torch.kernels import build

LAUNCHES = 0               # inference forward
TRAIN_LAUNCHES = 0         # training forward (also writes c)
BWD_LAUNCHES = 0           # backward, both directions in one launch
BWD_SINGLE_LAUNCHES = 0    # backward, one direction
# Backward launches by the walk's route (`bwd_plan`), both forms together.
BWD_ROUTES = {"resident": 0, "streamed": 0}
BWD_LAST_PLAN: dict = {}   # the last backward launch's plan and n_dirs
# Forward launches by the walk's route (`fwd_plan`), both forms together.
FWD_ROUTES = {"resident": 0, "streamed": 0}
FWD_LAST_PLAN: dict = {}   # the last forward launch's plan
# The widest layer the forward and backward kernels take: the streamed
# walks of both (csrc/lstm_bidir.cu, csrc/lstm_bidir_bwd.cu) keep h of a
# cluster's rows in shared memory up to this width.
MAX_H = 1024
_PLAN_KEYS = ("resident", "Rg", "groups", "U", "S", "thr", "smem",
              "clusters")


def _read_plan(fn: str, keys: tuple, *args) -> dict:
    """The plan a CUDA source's plan function writes, as a dict whose
    "resident" flag becomes "route"."""
    out = (ctypes.c_int * len(keys))()
    err = getattr(build.library(), fn)(*args, out)
    build.check(err, fn)
    plan = dict(zip(keys, out))
    plan["route"] = "resident" if plan.pop("resident") else "streamed"
    return plan


@functools.lru_cache(maxsize=None)
def fwd_plan(H: int, B: int, device_index: int) -> dict:
    """The forward walk's plan on the card, as csrc/lstm_bidir.cu chooses
    it (e2e_lstm_bidir_fwd_plan): the route ("resident": a block keeps its
    own gate columns of W_h in shared memory; "streamed": it brings them in
    every step), `cluster` blocks a cluster (16 where 4 rows a cluster put
    every cluster of the launch on the card at once, else 8), Rg rows a
    cluster walks in `groups` row groups, U units a block, RL rows and S
    threads a product lane, thr threads and smem bytes of shared memory a
    block, and the clusters of the plan the card holds at once."""
    with torch.cuda.device(device_index):
        return _read_plan("e2e_lstm_bidir_fwd_plan",
                          _PLAN_KEYS + ("cluster", "RL"), H, B)


@functools.lru_cache(maxsize=None)
def bwd_plan(H: int, B: int, n_dirs: int, device_index: int) -> dict:
    """The backward walk's plan on the card, as csrc/lstm_bidir_bwd.cu
    chooses it (e2e_lstm_bwd_plan): the route ("resident": a block keeps
    its own gate columns of W_h in shared memory; "streamed": it brings
    them in every step), Rg rows a cluster walks in `groups` row groups, U
    units a block, S threads a product lane, thr threads and smem bytes of
    shared memory a block, and the clusters the card holds at once."""
    with torch.cuda.device(device_index):
        return _read_plan("e2e_lstm_bwd_plan", _PLAN_KEYS, H, B, n_dirs)


def check_width(H: int, name: str = "lstm_seq_bidir") -> None:
    """ValueError for H above MAX_H, before any launch."""
    build.check_width(H, MAX_H, name)


def lstm_seq_bidir_reference(x_proj_fw, x_proj_bw, w_h_fw, w_h_bw, mask_bw,
                             save_c: bool = False):
    """Plain PyTorch version of the forward: (h_fw, h_bw), and with
    save_c also (c_fw, c_bw)."""
    T, B, H4 = x_proj_fw.shape
    H = H4 // 4
    zero = x_proj_fw.new_zeros(B, H)
    c_fw, h_fw, c_bw, h_bw = zero, zero, zero, zero
    out_fw, out_bw, cs_fw, cs_bw = [], [], [], []
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
        cs_fw.append(c_fw)
        cs_bw.append(c_bw)
    out = (torch.stack(out_fw), torch.stack(out_bw))
    if save_c:
        out += (torch.stack(cs_fw), torch.stack(cs_bw))
    return out


def lstm_bwd_reference(w_h, h, c, x_proj, g, mask=None):
    """Plain PyTorch version of the single-direction backward: from the
    forward's h, c [T,B,H], its inputs x_proj [T,B,4H], w_h [H,4H] and the
    output gradient g [T,B,H] -> (dx_proj [T,B,4H], dw_h [H,4H]). mask
    [T,B,1]: steps where it is 0 pass dh and dc through."""
    T, B, H = h.shape
    dh = h.new_zeros(B, H)
    dc = h.new_zeros(B, H)
    dw = torch.zeros_like(w_h)
    ones = h.new_ones(B, 1)
    dx = []
    for t in reversed(range(T)):
        h_prev = h[t - 1] if t > 0 else h.new_zeros(B, H)
        c_prev = c[t - 1] if t > 0 else h.new_zeros(B, H)
        gates = x_proj[t] + h_prev @ w_h
        i = torch.sigmoid(gates[:, :H])
        j = torch.tanh(gates[:, H:2 * H])
        f = torch.sigmoid(gates[:, 2 * H:3 * H] + 1.0)
        o = torch.sigmoid(gates[:, 3 * H:])
        tanh_c = torch.tanh(c[t])
        valid = mask[t] if mask is not None else ones
        dh_total = g[t] * valid + dh
        do = dh_total * tanh_c * o * (1.0 - o)
        dc_total = dh_total * o * (1.0 - tanh_c * tanh_c) + dc
        df = dc_total * c_prev * f * (1.0 - f)
        di = dc_total * j * i * (1.0 - i)
        dj = dc_total * i * (1.0 - j * j)
        dgates = torch.cat([di, dj, df, do], dim=-1) * valid
        dh = valid * (dgates @ w_h.T) + (1.0 - valid) * dh_total
        dc = valid * (dc_total * f) + (1.0 - valid) * dc
        dw = dw + h_prev.T @ dgates
        dx.append(dgates)
    return torch.stack(dx[::-1]), dw


def _check_forward(x_proj_fw, x_proj_bw, w_h_fw, w_h_bw, mask_bw):
    dev = x_proj_fw.device
    if dev.type != "cuda":
        raise ValueError(f"lstm_seq_bidir: unsupported device {dev}")
    T, B, H4 = x_proj_fw.shape
    if H4 % 4:
        raise ValueError(f"x_proj last dim {H4} is not 4*H")
    H = H4 // 4
    check_width(H)
    f32 = torch.float32
    build.require(x_proj_fw, "x_proj_fw", f32, (T, B, H4), dev)
    build.require(x_proj_bw, "x_proj_bw", f32, (T, B, H4), dev)
    build.require(w_h_fw, "w_h_fw", f32, (H, H4), dev)
    build.require(w_h_bw, "w_h_bw", f32, (H, H4), dev)
    build.require(mask_bw, "mask_bw", f32, (T, B, 1), dev)
    return dev, T, B, H


def fwd_cuda(x_proj_fw, x_proj_bw, w_h_fw, w_h_bw, mask_bw,
             save_c: bool = False):
    """One launch of the forward walk on the card, on the plan the source
    chooses (`fwd_plan`): (h_fw, h_bw), and with save_c also (c_fw, c_bw),
    each [T,B,H]."""
    global LAUNCHES, TRAIN_LAUNCHES, FWD_LAST_PLAN
    dev, T, B, H = _check_forward(x_proj_fw, x_proj_bw, w_h_fw, w_h_bw,
                                  mask_bw)
    plan = fwd_plan(H, B, dev.index)
    out = torch.empty(4 if save_c else 2, T, B, H, device=dev)
    ptrs = [x_proj_fw.data_ptr(), x_proj_bw.data_ptr(), w_h_fw.data_ptr(),
            w_h_bw.data_ptr(), mask_bw.data_ptr(),
            *[o.data_ptr() for o in out]]
    lib = build.library()
    fn = lib.e2e_lstm_bidir_fwd_train if save_c else lib.e2e_lstm_bidir_fwd
    with torch.cuda.device(dev):
        err = fn(*ptrs, T, B, H, plan["cluster"], plan["Rg"],
                 build.stream_ptr(dev))
    build.check(err, "lstm_seq_bidir_train" if save_c else "lstm_seq_bidir")
    if save_c:
        TRAIN_LAUNCHES += 1
    else:
        LAUNCHES += 1
    FWD_ROUTES[plan["route"]] += 1
    FWD_LAST_PLAN = dict(plan)
    return tuple(out.unbind(0))


def lstm_seq_bidir_train(x_proj_fw, x_proj_bw, w_h_fw, w_h_bw, mask_bw):
    """The training form: (h_fw, h_bw, c_fw, c_bw), each [T,B,H]."""
    if x_proj_fw.device.type == "cpu":
        return lstm_seq_bidir_reference(x_proj_fw, x_proj_bw, w_h_fw, w_h_bw,
                                        mask_bw, save_c=True)
    return fwd_cuda(x_proj_fw, x_proj_bw, w_h_fw, w_h_bw, mask_bw,
                    save_c=True)


def _bwd_cuda(dirs, T, B, H, dev):
    """One launch of the backward for 1 or 2 directions; dirs: tuples
    (w_h, h, c, x_proj, g, mask|None). Returns [(dx, dw)] per direction."""
    global BWD_LAST_PLAN
    check_width(H, "lstm_bwd")
    plan = bwd_plan(H, B, len(dirs), dev.index)
    tiles = -(-4 * H // 128) * -(-H // 128)   # dW_h's tiles (csrc/dw.cuh)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # dW_h's row splits: one wave of its 2-blocks-an-SM grid
    splits = max(1, min(64, 2 * sms // (tiles * len(dirs))))
    out, ptr_list = [], []
    for w, h, c, xp, g, mask in dirs:
        dx = torch.empty(T, B, 4 * H, device=dev)
        dw = torch.empty(H, 4 * H, device=dev)
        part = torch.empty(splits, H, 4 * H, device=dev)
        # W_h in the walk's layout: [8 blocks][4U gate columns][8U depths]
        wt = torch.empty(256 * plan["U"] ** 2, device=dev)
        ptr_list += [w, h, c, xp, g, mask, dx, dw, part, wt]
        out.append((dx, dw))
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.e2e_lstm_bwd(build.ptrs(*ptr_list), len(dirs), T, B, H,
                               splits, int(plan["route"] == "resident"),
                               plan["Rg"], build.stream_ptr(dev))
    build.check(err, "lstm_bwd")
    BWD_ROUTES[plan["route"]] += 1
    BWD_LAST_PLAN = {**plan, "n_dirs": len(dirs)}
    return out


def _check_bwd(w_h, h, c, x_proj, g, mask, dev, name):
    T, B, H = h.shape
    f32 = torch.float32
    req = build.require
    req(w_h, f"{name}.w_h", f32, (H, 4 * H), dev)
    req(h, f"{name}.h", f32, (T, B, H), dev)
    req(c, f"{name}.c", f32, (T, B, H), dev)
    req(x_proj, f"{name}.x_proj", f32, (T, B, 4 * H), dev)
    req(g, f"{name}.g", f32, (T, B, H), dev)
    if mask is not None:
        req(mask, f"{name}.mask", f32, (T, B, 1), dev)
    return T, B, H


def lstm_bwd(w_h, h, c, x_proj, g, mask=None):
    """Backward of one direction (the function of lstm_pallas._bwd_seq):
    -> (dx_proj [T,B,4H], dw_h [H,4H]). mask [T,B,1] or None."""
    global BWD_SINGLE_LAUNCHES
    if h.device.type == "cpu":
        return lstm_bwd_reference(w_h, h, c, x_proj, g, mask)
    if h.device.type != "cuda":
        raise ValueError(f"lstm_bwd: unsupported device {h.device}")
    T, B, H = _check_bwd(w_h, h, c, x_proj, g, mask, h.device, "lstm_bwd")
    (out,) = _bwd_cuda([(w_h, h, c, x_proj, g, mask)], T, B, H, h.device)
    BWD_SINGLE_LAUNCHES += 1
    return out


def lstm_bidir_bwd(w_h_fw, w_h_bw, h_fw, c_fw, x_proj_fw, g_fw, h_bw, c_bw,
                   x_proj_bw, g_bw, mask_bw):
    """Backward of both directions in one launch (the function of
    lstm_pallas._bwd_seq_bidir) -> (dx_fw, dw_fw, dx_bw, dw_bw)."""
    global BWD_LAUNCHES
    fw = (w_h_fw, h_fw, c_fw, x_proj_fw, g_fw, None)
    bw = (w_h_bw, h_bw, c_bw, x_proj_bw, g_bw, mask_bw)
    if h_fw.device.type == "cpu":
        return (*lstm_bwd_reference(*fw), *lstm_bwd_reference(*bw))
    if h_fw.device.type != "cuda":
        raise ValueError(f"lstm_bidir_bwd: unsupported device {h_fw.device}")
    T, B, H = _check_bwd(*fw, h_fw.device, "fw")
    _check_bwd(*bw, h_fw.device, "bw")
    (dx_fw, dw_fw), (dx_bw, dw_bw) = _bwd_cuda([fw, bw], T, B, H,
                                               h_fw.device)
    BWD_LAUNCHES += 1
    return dx_fw, dw_fw, dx_bw, dw_bw


class _LSTMBidir(torch.autograd.Function):
    """Training forward (saves h and c) with the hand-written backward."""

    @staticmethod
    def forward(ctx, x_proj_fw, x_proj_bw, w_h_fw, w_h_bw, mask_bw):
        h_fw, h_bw, c_fw, c_bw = lstm_seq_bidir_train(
            x_proj_fw, x_proj_bw, w_h_fw, w_h_bw, mask_bw)
        ctx.save_for_backward(x_proj_fw, x_proj_bw, w_h_fw, w_h_bw, mask_bw,
                              h_fw, h_bw, c_fw, c_bw)
        return h_fw, h_bw

    @staticmethod
    def backward(ctx, g_fw, g_bw):
        xf, xb, wf, wb, mask, h_fw, h_bw, c_fw, c_bw = ctx.saved_tensors
        g_fw = torch.zeros_like(h_fw) if g_fw is None else g_fw.contiguous()
        g_bw = torch.zeros_like(h_bw) if g_bw is None else g_bw.contiguous()
        dx_fw, dw_fw, dx_bw, dw_bw = lstm_bidir_bwd(
            wf, wb, h_fw, c_fw, xf, g_fw, h_bw, c_bw, xb, g_bw, mask)
        return dx_fw, dx_bw, dw_fw, dw_bw, None


def lstm_seq_bidir(x_proj_fw, x_proj_bw, w_h_fw, w_h_bw, mask_bw,
                   drop_seeds=None, bf16_matmul: bool = False,
                   drop_keep: float = 1.0):
    """Both directions of a bidirectional LSTM layer.

    x_proj_fw: [T,B,4H] input projection in natural time order;
    x_proj_bw: [T,B,4H] projection of the time-FLIPPED inputs;
    w_h_fw, w_h_bw: [H,4H] recurrent kernels; mask_bw: [T,B,1] validity of
    the flipped sequence (padding leads). Returns (h_fw [T,B,H] unmasked,
    h_bw_flipped [T,B,H] carry-through), all float32. Differentiable: when
    an input needs a gradient, the training form runs and the backward
    kernel gives the gradients.
    """
    if drop_seeds is not None or drop_keep < 1.0 or bf16_matmul:
        raise NotImplementedError(
            "lstm_seq_bidir: in-kernel dropout and bf16 matmuls are not "
            "ported yet (ROADMAP.md Queue 2, 'Speed levers': in-kernel "
            "Philox dropout; Queue 1, 'Decode features': bf16)")
    args = (x_proj_fw, x_proj_bw, w_h_fw, w_h_bw, mask_bw)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _LSTMBidir.apply(*args)
    if x_proj_fw.device.type == "cpu":
        return lstm_seq_bidir_reference(*args)
    return fwd_cuda(*args)
