"""Kernels #3 and #4: the forward of a unidirectional LSTM over a sequence
(`csrc/lstm_seq.cu` up to H = 1024, `csrc/lstm_seq_wide.cu` above), with
its backward on kernel #5 (`lstm_bidir.lstm_bwd`, `csrc/lstm_bidir_bwd.cu`,
up to H = 1024) or #5's wide form (`lstm_bwd_wide`, in
`csrc/lstm_seq_wide.cu`). The route is chosen by H alone (`WIDE`).

Replaces: e2e_asr_tpu/ops/lstm_pallas.py `_fwd_seq` through its entries
`lstm_seq` and `lstm_seq_masked` (without in-kernel dropout), the
residual-saving training form `_lstm_seq_fwd`, which also writes c, and
`_fwd_seq_chunked`, the form `_fwd_seq` takes when W_h cannot stay resident
(the JAX package takes it at H = 1280 for B = 16 and 128); and `_bwd_seq`
with `emit_dw=False`, the backward it takes there, whose dW_h is one
matmul outside the kernel.

Bound on the H100: the recurrence. Each of the T steps needs the whole
previous h, and every step reads all of W_h ([256, 1024] f32 = 1 MiB at
the flagship LM's width, 26.2 MB at H = 1280) from L2.

Design: #3 is kernel A's chain for one direction (`csrc/lstm_fwd.cuh`):
one block per batch row, the time loop inside the block, h in shared memory
and c in registers; at the LM task's B=128 the 128 chains fit one wave on
the 132 SMs. It caps H at 1024 (a block's threads). #4 is one persistent
cooperative launch over all steps with a grid barrier between steps, by one
of two routes, which the CUDA source chooses by H (`wide_fwd_plan` reads
it; counted in `WIDE_FWD_ROUTES`): "resident", where each of ceil(H / 10)
blocks keeps W_h's columns of 10 units in shared memory for the whole
sequence and brings h_{t-1} in through cp.async rings (1056 <= H <= 1280
on the H100), and "streamed" (wider), where each
tile of 8 units x 128 rows streams its W_h columns and h_{t-1} through
shared memory every step. #5's wide form recomputes the gates of every
step in one pass, then walks time in reverse: dh_{t-1} = dgates_t W_h^T
split by gate into four partial sums, then step t-1's cell backward, two
grid barriers a step. Both take H in multiples of 32.

Autograd: `lstm_seq` on inputs that need a gradient runs the training form
inside `_LSTMSeq`, whose backward is kernel #5 or its wide form on the card
and `lstm_bwd_reference` on the CPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from e2e_asr_tpu_torch.core.cells import _lstm_apply_gates
from e2e_asr_tpu_torch.kernels import build, lstm_bidir

WIDE = 1024            # the widest H of #3 and #5; wider takes #4 and #5-wide
LAUNCHES = 0           # inference form without a mask (lstm_seq)
MASKED_LAUNCHES = 0    # inference form with the carry mask (lstm_seq_masked)
TRAIN_LAUNCHES = 0     # training form (also writes c), with or without mask
WIDE_LAUNCHES = 0          # #4, the same three forms
WIDE_MASKED_LAUNCHES = 0
WIDE_TRAIN_LAUNCHES = 0
WIDE_BWD_LAUNCHES = 0      # #5's wide form
WIDE_FWD_ROUTES = {"resident": 0, "streamed": 0}   # #4's launches by route
WIDE_FWD_LAST_PLAN: dict = {}   # the plan of #4's last launch
WIDE_ROW_TILE = 128   # rows of a tile of the resident route's h scratch


@functools.lru_cache(maxsize=None)
def wide_fwd_plan(H: int, device_index: int) -> dict:
    """#4's route at width H on the card, as csrc/lstm_seq_wide.cu chooses
    it (e2e_lstm_wide_fwd_plan): "resident" where `blocks` blocks of
    `units` units each keep W_h's columns of their units in `smem` bytes of
    shared memory in one wave, else "streamed"."""
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device_index):
        err = build.library().e2e_lstm_wide_fwd_plan(H, out)
    build.check(err, "lstm_seq_wide_plan")
    return {"route": "resident" if out[0] else "streamed",
            "blocks": out[1], "units": out[2], "smem": out[3]}


def lstm_seq_reference(x_proj, w_h, mask=None, save_c: bool = False):
    """Plain PyTorch version: h [T,B,H] from a zero state, unmasked; with
    save_c, (h, c). mask [T,B,1]: steps where it is 0 keep (c, h)."""
    T, B, H4 = x_proj.shape
    H = H4 // 4
    h = c = x_proj.new_zeros(B, H)
    hs, cs = [], []
    for t in range(T):
        new_h, (new_c, _) = _lstm_apply_gates(x_proj[t] + h @ w_h, c, H)
        if mask is not None:
            valid = mask[t]
            new_c = valid * new_c + (1.0 - valid) * c
            new_h = valid * new_h + (1.0 - valid) * h
        h, c = new_h, new_c
        hs.append(h)
        cs.append(c)
    return (torch.stack(hs), torch.stack(cs)) if save_c else torch.stack(hs)


def _launch(x_proj, w_h, mask, save_c: bool) -> torch.Tensor:
    """One launch of the kernel: [1 or 2, T, B, H] = h (and c)."""
    global WIDE_FWD_LAST_PLAN
    dev = x_proj.device
    if dev.type != "cuda":
        raise ValueError(f"lstm_seq: unsupported device {dev}")
    T, B, H4 = x_proj.shape
    if H4 % 4:
        raise ValueError(f"x_proj last dim {H4} is not 4*H")
    H = H4 // 4
    f32 = torch.float32
    build.require(x_proj, "x_proj", f32, (T, B, H4), dev)
    build.require(w_h, "w_h", f32, (H, H4), dev)
    if mask is not None:
        build.require(mask, "mask", f32, (T, B, 1), dev)
    out = torch.empty(2 if save_c else 1, T, B, H, device=dev)
    lib = build.library()
    mask_ptr = None if mask is None else mask.data_ptr()
    with torch.cuda.device(dev):
        if H > WIDE:
            _check_wide(H)
            c = out[1] if save_c else torch.empty(B, H, device=dev)
            plan = wide_fwd_plan(H, dev.index)
            route = plan["route"]
            ht = (torch.empty(2, -(-B // WIDE_ROW_TILE), H, WIDE_ROW_TILE,
                              device=dev) if route == "resident" else None)
            err = lib.e2e_lstm_wide_fwd(
                x_proj.data_ptr(), w_h.data_ptr(), mask_ptr,
                out[0].data_ptr(), c.data_ptr(), int(save_c), T, B, H,
                int(route == "resident"),
                None if ht is None else ht.data_ptr(), build.stream_ptr(dev))
        else:
            err = lib.e2e_lstm_seq_fwd(
                x_proj.data_ptr(), w_h.data_ptr(), mask_ptr,
                out[0].data_ptr(), out[1].data_ptr() if save_c else None, T,
                B, H, build.stream_ptr(dev))
    build.check(err, "lstm_seq_wide" if H > WIDE else "lstm_seq")
    if H > WIDE:
        WIDE_FWD_ROUTES[route] += 1
        WIDE_FWD_LAST_PLAN = plan
    return out


def _check_wide(H: int) -> None:
    """#4 and #5's wide form load whole groups of 32 units (as the JAX
    package's chunked forward needs H to split into tiles of 8 or more)."""
    if H % 32:
        raise ValueError(f"lstm_seq: H={H} > {WIDE} takes kernels #4 and #5's "
                         "wide form, which need H to be a multiple of 32")


def _count(H: int, form: str) -> None:
    """One launch of `form` ("", "MASKED_" or "TRAIN_") on #3 or #4."""
    name = ("WIDE_" if H > WIDE else "") + form + "LAUNCHES"
    globals()[name] += 1


def lstm_bwd_wide(w_h, h, c, x_proj, g, mask=None):
    """The backward of one direction for H > WIDE (the function of
    lstm_pallas._bwd_seq with emit_dw=False) -> (dx_proj [T,B,4H], dw_h
    [H,4H]): dx_proj from #5's wide form, dw_h = sum over t of h_{t-1}^T
    dx_proj[t] as one matmul outside the kernel. Its plain version (CPU
    tensors) is lstm_bidir.lstm_bwd_reference."""
    if h.device.type == "cpu":
        return lstm_bidir.lstm_bwd_reference(w_h, h, c, x_proj, g, mask)
    dx = lstm_bwd_wide_dx(w_h, h, c, x_proj, g, mask)
    return dx, wide_dw(h, dx)


def lstm_bwd_wide_dx(w_h, h, c, x_proj, g, mask=None):
    """One launch of #5's wide form on CUDA tensors: dx_proj [T,B,4H]."""
    global WIDE_BWD_LAUNCHES
    if h.device.type != "cuda":
        raise ValueError(f"lstm_bwd_wide: unsupported device {h.device}")
    dev = h.device
    T, B, H = lstm_bidir._check_bwd(w_h, h, c, x_proj, g, mask, dev,
                                    "lstm_bwd_wide")
    _check_wide(H)
    dx = torch.empty(T, B, 4 * H, device=dev)
    dc, dht = torch.empty(B, H, device=dev), torch.empty(B, H, device=dev)
    part = torch.empty(4, B, H, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.e2e_lstm_wide_bwd(
            w_h.data_ptr(), h.data_ptr(), c.data_ptr(), x_proj.data_ptr(),
            g.data_ptr(), None if mask is None else mask.data_ptr(),
            dx.data_ptr(), dc.data_ptr(), dht.data_ptr(), part.data_ptr(), T,
            B, H, build.stream_ptr(dev))
    build.check(err, "lstm_bwd_wide")
    WIDE_BWD_LAUNCHES += 1
    return dx


def wide_dw(h, dx):
    """dW_h of #5's wide form: h_{t-1}^T dgates_t summed over t, one
    matmul over the (T-1)*B rows (h_{-1} is zero)."""
    T, B, H = h.shape
    return h[:-1].reshape(-1, H).t() @ dx[1:].reshape(-1, 4 * H)


def lstm_seq_train(x_proj, w_h, mask=None):
    """The training form: (h, c), each [T,B,H]."""
    if x_proj.device.type == "cpu":
        return lstm_seq_reference(x_proj, w_h, mask, save_c=True)
    out = _launch(x_proj, w_h, mask, save_c=True)
    _count(w_h.shape[0], "TRAIN_")
    return out[0], out[1]


class _LSTMSeq(torch.autograd.Function):
    """Training forward (saves h and c) with kernel #5, or its wide form,
    as its backward."""

    @staticmethod
    def forward(ctx, x_proj, w_h, mask):
        h, c = lstm_seq_train(x_proj, w_h, mask)
        ctx.save_for_backward(x_proj, w_h, mask, h, c)
        return h

    @staticmethod
    def backward(ctx, g):
        x_proj, w_h, mask, h, c = ctx.saved_tensors
        bwd = lstm_bwd_wide if w_h.shape[0] > WIDE else lstm_bidir.lstm_bwd
        dx, dw = bwd(w_h, h, c, x_proj, g.contiguous(), mask)
        return dx, dw, None


def lstm_seq(x_proj, w_h, mask=None, drop_seed=None,
             bf16_matmul: bool = False, drop_keep: float = 1.0):
    """Unidirectional LSTM over x_proj [T,B,4H] (input projection + bias)
    with recurrent kernel w_h [H,4H] from a zero state -> h [T,B,H],
    unmasked. mask [T,B,1] float or None: steps where it is 0 carry the
    state through (lstm_pallas.lstm_seq_masked). Differentiable in x_proj
    and w_h: when either needs a gradient, the training form runs and kernel
    #5 (its wide form above WIDE) gives the gradients. The reference's
    in-kernel dropout (drop_seed, drop_keep) and bf16 matmuls raise:
    dropout runs on the output outside the kernel."""
    if drop_seed is not None or drop_keep < 1.0 or bf16_matmul:
        raise NotImplementedError(
            "lstm_seq: in-kernel dropout and bf16 matmuls are not ported "
            "yet (ROADMAP.md Queue 2, 'Speed levers': in-kernel Philox "
            "dropout; Queue 1, 'Decode features': bf16)")
    if torch.is_grad_enabled() and (x_proj.requires_grad
                                    or w_h.requires_grad):
        return _LSTMSeq.apply(x_proj, w_h, mask)
    if x_proj.device.type == "cpu":
        return lstm_seq_reference(x_proj, w_h, mask)
    h = _launch(x_proj, w_h, mask, save_c=False)[0]
    _count(w_h.shape[0], "" if mask is None else "MASKED_")
    return h
