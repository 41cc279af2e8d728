"""Kernel #6: a GRU layer's forward over a sequence, one direction or both
directions of a bidirectional layer in one launch (`csrc/gru_seq.cu`), and
its backward, kernel #7 (`csrc/gru_bwd.cu`).

Replaces: e2e_asr_tpu/ops/gru_pallas.py `_fwd_seq` through its entries
`gru_seq` and `gru_seq_masked` (without in-kernel dropout), and its
backward `_bwd_seq`. The JAX package runs a bidirectional GRU layer as two
launches, `gru_seq` on the input and `gru_seq_masked` on the time-flipped
input (core/rnn.py:373-415); `gru_seq_bidir` runs both chains in one launch,
which computes the same function.

Bound on the H100: the recurrence. Each of the T steps needs the whole
previous h, and a step is two dependent products: the gates' h @ W_gh and
the candidate's (r*h) @ W_ch, whose input needs all of r. W_gh [256, 512]
and W_ch [256, 256] (768 KiB f32 at the flagship width) exceed a block's
shared memory, so every step reads them from L2.

Design: one block per chain (batch row x direction), the time loop inside
the block, h in shared memory; each hidden unit's r, u and c columns are
read by S neighbouring lanes over slices of the reduction depth, their sums
meeting by warp shuffles, so a step takes two __syncthreads
(`csrc/gru_fwd.cuh`). The training form also writes r | u and c of every
step; the backward reads them instead of recomputing the two products, and
walks time in reverse with two dependent products a step (d(rh) = dcpre @
W_ch^T, then dgates @ W_gh^T), then leaves dW_gh and dW_ch to a tiled
reduction over the T*B rows in a fixed order (`csrc/dw.cuh`).

Semantics kept from the reference: the backward direction runs on the
time-flipped input, where padding leads, and carries h through steps whose
mask is 0 (its gradient passes dh through them); the outputs are unmasked
h, which the caller masks and flips back (core/rnn.py).

Autograd: the entries on inputs that need a gradient run the training form
inside `_GRUSeq` / `_GRUBidir`, whose backward is kernel #7 on the card and
`gru_bwd_reference` on the CPU.
"""
from __future__ import annotations

import torch

from e2e_asr_tpu_torch.kernels import build

LAUNCHES = 0               # inference, both directions (gru_seq_bidir)
SEQ_LAUNCHES = 0           # inference, one direction without a mask
MASKED_LAUNCHES = 0        # inference, one direction with the carry mask
TRAIN_LAUNCHES = 0         # training form (also writes r | u and c)
BWD_LAUNCHES = 0           # kernel #7, both directions in one launch
BWD_SINGLE_LAUNCHES = 0    # kernel #7, one direction
# The widest layer kernels #6 and #7 take: a block holds one thread per unit
# (csrc/gru_seq.cu, csrc/gru_bwd.cu).
MAX_H = 1024


def check_width(H: int, name: str = "gru_seq") -> None:
    """ValueError for H above MAX_H, before any launch."""
    build.check_width(H, MAX_H, name)


def gru_seq_reference(gates_x, cand_x, w_gh, w_ch, mask=None,
                      save: bool = False):
    """Plain PyTorch version of the forward from a zero state: h [T,B,H],
    unmasked; with save, (h, ru [T,B,2H], c [T,B,H]). mask [T,B,1]: steps
    where it is 0 keep h."""
    T, B, H = cand_x.shape
    h = cand_x.new_zeros(B, H)
    hs, rus, cs = [], [], []
    for t in range(T):
        ru = torch.sigmoid(gates_x[t] + h @ w_gh)
        r, u = ru[:, :H], ru[:, H:]
        c = torch.tanh(cand_x[t] + (r * h) @ w_ch)
        new_h = u * h + (1.0 - u) * c
        if mask is not None:
            new_h = mask[t] * new_h + (1.0 - mask[t]) * h
        h = new_h
        hs.append(h)
        rus.append(ru)
        cs.append(c)
    if save:
        return torch.stack(hs), torch.stack(rus), torch.stack(cs)
    return torch.stack(hs)


def gru_bwd_reference(w_gh, w_ch, h, ru, c, g, mask=None):
    """Plain PyTorch version of the backward (the function of
    gru_pallas._bwd_seq): from the forward's h, r | u and c, and the output
    gradient g [T,B,H] -> (dgates_x [T,B,2H], dcand_x [T,B,H], dw_gh
    [H,2H], dw_ch [H,H]). mask [T,B,1]: steps where it is 0 pass dh
    through and give zero gradients."""
    T, B, H = h.shape
    dh = h.new_zeros(B, H)
    dwg, dwc = torch.zeros_like(w_gh), torch.zeros_like(w_ch)
    dgx, dcx = [], []
    for t in reversed(range(T)):
        h_prev = h[t - 1] if t > 0 else h.new_zeros(B, H)
        r, u = ru[t][:, :H], ru[t][:, H:]
        dh_total = g[t] + dh
        du = dh_total * (h_prev - c[t])
        dcpre = dh_total * (1.0 - u) * (1.0 - c[t] * c[t])
        drh = dcpre @ w_ch.T
        dgpre = torch.cat([drh * h_prev * r * (1.0 - r),
                           du * u * (1.0 - u)], dim=-1)
        dh_prev = dh_total * u + drh * r + dgpre @ w_gh.T
        if mask is not None:
            valid = mask[t]
            dgpre, dcpre = dgpre * valid, dcpre * valid
            dh_prev = valid * dh_prev + (1.0 - valid) * dh_total
        dh = dh_prev
        dwg = dwg + h_prev.T @ dgpre
        dwc = dwc + (r * h_prev).T @ dcpre
        dgx.append(dgpre)
        dcx.append(dcpre)
    return torch.stack(dgx[::-1]), torch.stack(dcx[::-1]), dwg, dwc


def _check_dir(gx, cx, wg, wc, mask, dev, name):
    T, B, H = cx.shape
    f32, req = torch.float32, build.require
    req(gx, f"{name}.gates_x", f32, (T, B, 2 * H), dev)
    req(cx, f"{name}.cand_x", f32, (T, B, H), dev)
    req(wg, f"{name}.w_gh", f32, (H, 2 * H), dev)
    req(wc, f"{name}.w_ch", f32, (H, H), dev)
    if mask is not None:
        req(mask, f"{name}.mask", f32, (T, B, 1), dev)
    return T, B, H


def _fwd_cuda(dirs, train: bool, name: str):
    """One launch of the forward for 1 or 2 directions; dirs: tuples
    (gates_x, cand_x, w_gh, w_ch, mask|None). Returns per direction h, or
    (h, ru, c) in the training form."""
    dev = dirs[0][1].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    T, B, H = dirs[0][1].shape
    check_width(H, name)
    for i, d in enumerate(dirs):
        _check_dir(*d, dev, f"{name}[{i}]")
    outs, ptr_list = [], []
    for gx, cx, wg, wc, mask in dirs:
        h = torch.empty(T, B, H, device=dev)
        ru = torch.empty(T, B, 2 * H, device=dev) if train else None
        c = torch.empty(T, B, H, device=dev) if train else None
        ptr_list += [gx, cx, wg, wc, mask, h, ru, c]
        outs.append((h, ru, c) if train else h)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.e2e_gru_fwd(build.ptrs(*ptr_list), len(dirs), T, B, H,
                              build.stream_ptr(dev))
    build.check(err, name)
    return outs


def _bwd_cuda(dirs, name: str):
    """One launch of kernel #7 for 1 or 2 directions; dirs: tuples (w_gh,
    w_ch, h, ru, c, g, mask|None). Returns per direction (dgates_x,
    dcand_x, dw_gh, dw_ch)."""
    dev = dirs[0][2].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    T, B, H = dirs[0][2].shape
    check_width(H, name)
    f32, req = torch.float32, build.require
    for i, (wg, wc, h, ru, c, g, mask) in enumerate(dirs):
        req(wg, f"{name}[{i}].w_gh", f32, (H, 2 * H), dev)
        req(wc, f"{name}[{i}].w_ch", f32, (H, H), dev)
        for t, n, w in ((h, "h", H), (ru, "ru", 2 * H), (c, "c", H),
                        (g, "g", H)):
            req(t, f"{name}[{i}].{n}", f32, (T, B, w), dev)
        if mask is not None:
            req(mask, f"{name}[{i}].mask", f32, (T, B, 1), dev)
    tiles = -(-H // 128) * -(-2 * H // 128)   # dW's tiles (csrc/dw.cuh)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = max(1, min(64, -(-2 * sms // (tiles * 2 * len(dirs)))))
    new = lambda *shape: torch.empty(*shape, device=dev)  # noqa: E731
    outs, ptr_list = [], []
    for wg, wc, h, ru, c, g, mask in dirs:
        out = (new(T, B, 2 * H), new(T, B, H), new(H, 2 * H), new(H, H))
        ptr_list += [wg.t().contiguous(), wc.t().contiguous(), h, ru, c, g,
                     mask, *out, new(T, B, H), new(splits, H, 2 * H),
                     new(splits, H, H)]
        outs.append(out)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.e2e_gru_bwd(build.ptrs(*ptr_list), len(dirs), T, B, H,
                              splits, build.stream_ptr(dev))
    build.check(err, name)
    return outs


def gru_seq_train(gates_x, cand_x, w_gh, w_ch, mask=None):
    """The training form of one direction: (h, ru, c)."""
    global TRAIN_LAUNCHES
    if cand_x.device.type == "cpu":
        return gru_seq_reference(gates_x, cand_x, w_gh, w_ch, mask,
                                 save=True)
    (out,) = _fwd_cuda([(gates_x, cand_x, w_gh, w_ch, mask)], True,
                       "gru_seq_train")
    TRAIN_LAUNCHES += 1
    return out


def gru_seq_bidir_train(gx_fw, cx_fw, gx_bw, cx_bw, wg_fw, wc_fw, wg_bw,
                        wc_bw, mask_bw):
    """The training form of both directions in one launch: ((h, ru, c) of
    the forward direction, (h, ru, c) of the backward one)."""
    global TRAIN_LAUNCHES
    fw = (gx_fw, cx_fw, wg_fw, wc_fw, None)
    bw = (gx_bw, cx_bw, wg_bw, wc_bw, mask_bw)
    if cx_fw.device.type == "cpu":
        return (gru_seq_reference(*fw, save=True),
                gru_seq_reference(*bw, save=True))
    out = _fwd_cuda([fw, bw], True, "gru_seq_bidir_train")
    TRAIN_LAUNCHES += 1
    return tuple(out)


def gru_bwd(w_gh, w_ch, h, ru, c, g, mask=None):
    """Kernel #7 for one direction -> (dgates_x, dcand_x, dw_gh, dw_ch)."""
    global BWD_SINGLE_LAUNCHES
    args = (w_gh, w_ch, h, ru, c, g, mask)
    if h.device.type == "cpu":
        return gru_bwd_reference(*args)
    (out,) = _bwd_cuda([args], "gru_bwd")
    BWD_SINGLE_LAUNCHES += 1
    return out


def gru_bidir_bwd(fw: tuple, bw: tuple):
    """Kernel #7 for both directions in one launch; fw, bw: (w_gh, w_ch,
    h, ru, c, g, mask|None) -> (per-direction outputs of gru_bwd)."""
    global BWD_LAUNCHES
    if fw[2].device.type == "cpu":
        return gru_bwd_reference(*fw), gru_bwd_reference(*bw)
    out = _bwd_cuda([fw, bw], "gru_bidir_bwd")
    BWD_LAUNCHES += 1
    return tuple(out)


class _GRUSeq(torch.autograd.Function):
    """Training forward (saves h, r | u, c) with kernel #7 as backward."""

    @staticmethod
    def forward(ctx, gates_x, cand_x, w_gh, w_ch, mask):
        h, ru, c = gru_seq_train(gates_x, cand_x, w_gh, w_ch, mask)
        ctx.save_for_backward(w_gh, w_ch, mask, h, ru, c)
        return h

    @staticmethod
    def backward(ctx, g):
        w_gh, w_ch, mask, h, ru, c = ctx.saved_tensors
        dgx, dcx, dwg, dwc = gru_bwd(w_gh, w_ch, h, ru, c, g.contiguous(),
                                     mask)
        return dgx, dcx, dwg, dwc, None


class _GRUBidir(torch.autograd.Function):
    """Both directions' training forward with kernel #7 as backward."""

    @staticmethod
    def forward(ctx, gx_fw, cx_fw, gx_bw, cx_bw, wg_fw, wc_fw, wg_bw, wc_bw,
                mask_bw):
        (h_fw, ru_fw, c_fw), (h_bw, ru_bw, c_bw) = gru_seq_bidir_train(
            gx_fw, cx_fw, gx_bw, cx_bw, wg_fw, wc_fw, wg_bw, wc_bw, mask_bw)
        ctx.save_for_backward(wg_fw, wc_fw, wg_bw, wc_bw, mask_bw, h_fw,
                              ru_fw, c_fw, h_bw, ru_bw, c_bw)
        return h_fw, h_bw

    @staticmethod
    def backward(ctx, g_fw, g_bw):
        (wg_fw, wc_fw, wg_bw, wc_bw, mask, h_fw, ru_fw, c_fw, h_bw, ru_bw,
         c_bw) = ctx.saved_tensors
        g_fw = torch.zeros_like(h_fw) if g_fw is None else g_fw.contiguous()
        g_bw = torch.zeros_like(h_bw) if g_bw is None else g_bw.contiguous()
        fw, bw = gru_bidir_bwd(
            (wg_fw, wc_fw, h_fw, ru_fw, c_fw, g_fw, None),
            (wg_bw, wc_bw, h_bw, ru_bw, c_bw, g_bw, mask))
        return (fw[0], fw[1], bw[0], bw[1], fw[2], fw[3], bw[2], bw[3],
                None)


def _check_options(drop, bf16_matmul: bool, drop_keep: float, name: str):
    if drop is not None or drop_keep < 1.0 or bf16_matmul:
        raise NotImplementedError(
            f"{name}: in-kernel dropout and bf16 matmuls are not ported yet "
            "(ROADMAP.md Queue 2, 'Speed levers': in-kernel Philox dropout; "
            "Queue 1, 'Decode features': bf16)")


def _needs_grad(args) -> bool:
    return torch.is_grad_enabled() and any(
        a is not None and a.requires_grad for a in args)


def gru_seq(gates_x, cand_x, w_gh, w_ch, mask=None, drop_seed=None,
            bf16_matmul: bool = False, drop_keep: float = 1.0):
    """One GRU direction over gates_x [T,B,2H] (x@W_gx + b_g), cand_x
    [T,B,H] (x@W_cx + b_c), with recurrent kernels w_gh [H,2H] and w_ch
    [H,H], from a zero state -> h [T,B,H], unmasked. mask [T,B,1] float or
    None: steps where it is 0 carry h through (gru_pallas.gru_seq_masked).
    Differentiable: when an input needs a gradient, the training form runs
    and kernel #7 gives the gradients. In-kernel dropout and bf16 raise:
    dropout runs on the layer's output outside the kernel."""
    global SEQ_LAUNCHES, MASKED_LAUNCHES
    _check_options(drop_seed, bf16_matmul, drop_keep, "gru_seq")
    args = (gates_x, cand_x, w_gh, w_ch, mask)
    if _needs_grad(args[:4]):
        return _GRUSeq.apply(*args)
    if cand_x.device.type == "cpu":
        return gru_seq_reference(*args)
    (h,) = _fwd_cuda([args], False, "gru_seq")
    if mask is None:
        SEQ_LAUNCHES += 1
    else:
        MASKED_LAUNCHES += 1
    return h


def gru_seq_bidir(gx_fw, cx_fw, gx_bw, cx_bw, wg_fw, wc_fw, wg_bw, wc_bw,
                  mask_bw):
    """Both directions of a bidirectional GRU layer in one launch.

    gx_fw, cx_fw: the input contributions in natural time order; gx_bw,
    cx_bw: those of the time-FLIPPED inputs; w*: each direction's recurrent
    kernels; mask_bw [T,B,1]: validity of the flipped sequence (padding
    leads). Returns (h_fw [T,B,H] unmasked, h_bw_flipped [T,B,H]
    carry-through). Differentiable like gru_seq."""
    global LAUNCHES
    args = (gx_fw, cx_fw, gx_bw, cx_bw, wg_fw, wc_fw, wg_bw, wc_bw, mask_bw)
    if _needs_grad(args[:8]):
        return _GRUBidir.apply(*args)
    if cx_fw.device.type == "cpu":
        return (gru_seq_reference(gx_fw, cx_fw, wg_fw, wc_fw),
                gru_seq_reference(gx_bw, cx_bw, wg_bw, wc_bw, mask_bw))
    h_fw, h_bw = _fwd_cuda([(gx_fw, cx_fw, wg_fw, wc_fw, None),
                            (gx_bw, cx_bw, wg_bw, wc_bw, mask_bw)], False,
                           "gru_seq_bidir")
    LAUNCHES += 1
    return h_fw, h_bw
