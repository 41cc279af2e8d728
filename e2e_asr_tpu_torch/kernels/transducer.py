"""Kernel #17: the transducer (RNN-T) lattice loss, forward and backward
(`csrc/transducer.cu`).

Replaces: e2e_asr_tpu/ops/transducer_pallas.py `_fwd_call` (body
`_fwd_kernel`) and `_bwd_call` (body `_bwd_kernel`), under the custom VJP
`transducer_loss_pallas`.

Bound on the H100: latency. The lattices are small (each [B, T, U+1]
float32 tensor is 1.18 MB at the bench's B=128, T'=48, U=47: the forward
moves about 3.5 MB, the backward about 5.9 MB), but each example's
recurrence is a chain of T+U-1 dependent steps.

Design: one block per example, the threads over u, walking the lattice's
anti-diagonals t+u = d (a cell depends only on the previous diagonal):
T+U steps, one barrier each, no scan. The forward saves alpha [B,T,U+1]
for the backward, which walks the diagonals in reverse and writes the
occupancy gradients as it goes, so beta is never stored.

`transducer_loss` is the autograd entry: on CUDA tensors the forward
kernel, with the backward kernel as its gradient (`_TransducerLoss`); on
CPU tensors the plain forward `transducer_fwd_reference`, differentiated by
autograd (as the JAX package's XLA path is). `transducer_bwd_reference` is
the plain version of the backward kernel: the explicit beta pass and
occupancies.
"""
from __future__ import annotations

import torch

from e2e_asr_tpu_torch.kernels import build

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
NEG = -1e30   # effective log(0); finite so (-inf) - (-inf) never appears


def _prepare(blank_lp, label_lp, t_lens, u_lens):
    """The lattices in float32 (float64 stays float64: the plain versions
    then compute in float64), the lengths clamped (t to [1, T], u to
    [0, U]) and labels at u >= u_len masked to NEG: (blank, label, tl,
    ul)."""
    B, T, U1 = blank_lp.shape
    dev = blank_lp.device
    dtype = torch.promote_types(blank_lp.dtype, torch.float32)
    tl = t_lens.to(dev, torch.int64).clamp(1, T)
    ul = u_lens.to(dev, torch.int64).clamp(0, U1 - 1)
    u_idx = torch.arange(U1 - 1, device=dev)[None, None, :]
    label = torch.where(u_idx < ul[:, None, None], label_lp.to(dtype),
                        torch.full((), NEG, dtype=dtype, device=dev))
    return blank_lp.to(dtype), label, tl, ul


def _row_scan(a, b):
    """Solve x[u] = logaddexp(b[u], x[u-1] + a[u]) over the last axis
    (x[-1] = log 0) as a Hillis-Steele prefix scan of the affine maps
    x -> logaddexp(b, x + a) in the (logaddexp, +) semiring, the form of
    the reference's associative scan."""
    n, d = a.shape[-1], 1
    while d < n:
        a_s = torch.nn.functional.pad(a[..., :-d], (d, 0), value=0.0)
        b_s = torch.nn.functional.pad(b[..., :-d], (d, 0), value=NEG)
        a, b = a_s + a, torch.logaddexp(b_s + a, b)
        d *= 2
    return b


def transducer_fwd_reference(blank_lp, label_lp, t_lens, u_lens):
    """Plain PyTorch version of the forward: (loss [B], alpha [B,T,U+1]).
    The alpha recurrence as a loop over t, each row a log-semiring
    cumulative pass over u; differentiable by autograd."""
    blank, label, tl, ul = _prepare(blank_lp, label_lp, t_lens, u_lens)
    B, T, U1 = blank.shape
    neg = torch.full((B, 1), NEG, dtype=blank.dtype, device=blank.device)
    rows = [torch.cat([torch.zeros_like(neg),
                       torch.cumsum(label[:, 0], dim=-1)], dim=-1)]
    for t in range(1, T):
        a = torch.cat([neg, label[:, t]], dim=-1)
        rows.append(_row_scan(a, rows[-1] + blank[:, t - 1]))
    alpha = torch.stack(rows, dim=1)                           # [B,T,U1]
    b_idx = torch.arange(B, device=blank.device)
    last = alpha[b_idx, tl - 1, ul] + blank[b_idx, tl - 1, ul]
    return -last, alpha


def _row_scan_up(a, b):
    """Solve x[u] = logaddexp(b[u], x[u+1] + a[u]) over the last axis
    (x[n] = log 0): _row_scan on the reversed axis."""
    return torch.flip(_row_scan(torch.flip(a, [-1]), torch.flip(b, [-1])),
                      [-1])


def transducer_bwd_reference(blank_lp, label_lp, t_lens, u_lens, alpha,
                             loss, g):
    """Plain PyTorch version of the backward: (gblank [B,T,U+1], glabel
    [B,T,U]) for the output gradient g [B], from the forward's alpha and
    loss. The beta recurrence in reverse over t, entered through the
    virtual exit row beta[t_len, u] = (u == u_len ? 0 : log 0), and the
    occupancies; exact zeros outside each example's lattice."""
    blank, label, tl, ul = _prepare(blank_lp, label_lp, t_lens, u_lens)
    B, T, U1 = blank.shape
    dev, neg = blank.device, torch.full((), NEG, dtype=blank.dtype,
                                        device=blank.device)
    u_idx = torch.arange(U1, device=dev)[None, :]
    virt = torch.where(u_idx == ul[:, None], 0.0, neg)          # [B, U1]
    label_pad = torch.cat([label, neg.expand(B, T, 1)], dim=-1)  # [B,T,U1]
    logz, scale = -loss[:, None], -g[:, None]
    beta = neg.expand(B, U1)
    gblank, glabel = [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        down = torch.where((tl - 1 == t)[:, None], virt, beta)  # beta[t+1]
        gblank[t] = torch.exp(alpha[:, t] + blank[:, t] + down - logz)
        beta = _row_scan_up(label_pad[:, t], blank[:, t] + down)
        right = torch.nn.functional.pad(beta[:, 1:], (0, 1), value=NEG)
        glabel[t] = torch.exp(alpha[:, t] + label_pad[:, t] + right - logz)
    t_idx = torch.arange(T, device=dev)[None, :, None]
    inside_t = t_idx < tl[:, None, None]
    gb = torch.where(inside_t & (u_idx[:, None, :] <= ul[:, None, None]),
                     torch.stack(gblank, 1) * scale[:, :, None], 0.0)
    gl = torch.where(inside_t & (u_idx[:, None, :-1] < ul[:, None, None]),
                     torch.stack(glabel, 1)[..., :-1] * scale[:, :, None],
                     0.0)
    return gb, gl


def _lattice_args(blank_lp, label_lp, t_lens, u_lens):
    """The kernels' inputs, validated: contiguous float32 lattices and
    int32 lengths on the lattices' device."""
    dev = blank_lp.device
    B, T, U1 = blank_lp.shape
    blank = blank_lp.float().contiguous()
    label = label_lp.float().contiguous()
    tl = t_lens.to(dev, torch.int32).contiguous()
    ul = u_lens.to(dev, torch.int32).contiguous()
    build.require(blank, "blank_lp", torch.float32, (B, T, U1), dev)
    build.require(label, "label_lp", torch.float32, (B, T, U1 - 1), dev)
    build.require(tl, "t_lens", torch.int32, (B,), dev)
    build.require(ul, "u_lens", torch.int32, (B,), dev)
    return blank, label, tl, ul


def transducer_fwd(blank_lp, label_lp, t_lens, u_lens):
    """(loss [B], alpha [B,T,U+1]) of the lattices blank_lp [B,T,U+1],
    label_lp [B,T,U] with lengths t_lens, u_lens [B]: the forward kernel on
    CUDA tensors, its plain version on CPU tensors. alpha is defined where
    t < t_len and u <= u_len (the kernel leaves the rest unwritten)."""
    global FWD_LAUNCHES
    if blank_lp.device.type == "cpu":
        return transducer_fwd_reference(blank_lp, label_lp, t_lens, u_lens)
    dev = blank_lp.device
    if dev.type != "cuda":
        raise ValueError(f"transducer_fwd: unsupported device {dev}")
    blank, label, tl, ul = _lattice_args(blank_lp, label_lp, t_lens, u_lens)
    B, T, U1 = blank.shape
    loss = torch.empty(B, device=dev)
    alpha = torch.empty(B, T, U1, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.e2e_transducer_fwd(
            blank.data_ptr(), label.data_ptr(), tl.data_ptr(), ul.data_ptr(),
            loss.data_ptr(), alpha.data_ptr(), B, T, U1,
            build.stream_ptr(dev))
    build.check(err, "transducer_fwd")
    FWD_LAUNCHES += 1
    return loss, alpha


def transducer_bwd(blank_lp, label_lp, t_lens, u_lens, alpha, loss, g):
    """(gblank [B,T,U+1], glabel [B,T,U]): the gradients of sum(loss * g)
    with respect to the lattices, from the forward's alpha and loss: the
    backward kernel on CUDA tensors, its plain version on CPU tensors."""
    global BWD_LAUNCHES
    if blank_lp.device.type == "cpu":
        return transducer_bwd_reference(blank_lp, label_lp, t_lens, u_lens,
                                        alpha, loss, g)
    dev = blank_lp.device
    if dev.type != "cuda":
        raise ValueError(f"transducer_bwd: unsupported device {dev}")
    blank, label, tl, ul = _lattice_args(blank_lp, label_lp, t_lens, u_lens)
    B, T, U1 = blank.shape
    g = g.float().contiguous()
    for t, name, shape in ((alpha, "alpha", (B, T, U1)), (loss, "loss", (B,)),
                           (g, "g", (B,))):
        build.require(t, name, torch.float32, shape, dev)
    gblank = torch.empty(B, T, U1, device=dev)
    glabel = torch.empty(B, T, U1 - 1, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.e2e_transducer_bwd(
            blank.data_ptr(), label.data_ptr(), tl.data_ptr(), ul.data_ptr(),
            alpha.data_ptr(), loss.data_ptr(), g.data_ptr(),
            gblank.data_ptr(), glabel.data_ptr(), B, T, U1,
            build.stream_ptr(dev))
    build.check(err, "transducer_bwd")
    BWD_LAUNCHES += 1
    return gblank, glabel


class _TransducerLoss(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, blank_lp, label_lp, t_lens, u_lens):
        loss, alpha = transducer_fwd(blank_lp, label_lp, t_lens, u_lens)
        ctx.save_for_backward(blank_lp, label_lp, t_lens, u_lens, alpha,
                              loss)
        return loss

    @staticmethod
    def backward(ctx, g):
        blank_lp, label_lp, t_lens, u_lens, alpha, loss = ctx.saved_tensors
        gblank, glabel = transducer_bwd(blank_lp, label_lp, t_lens, u_lens,
                                        alpha, loss, g)
        return gblank, glabel, None, None


def transducer_loss(blank_lp, label_lp, t_lens, u_lens):
    """Per-example negative log-likelihood [B] of the lattices blank_lp
    [B,T,U+1] and label_lp [B,T,U] (lengths t_lens, u_lens [B]),
    differentiable in both lattices: kernel #17 forward and backward on
    CUDA tensors, the plain forward under autograd on CPU tensors."""
    if blank_lp.device.type == "cpu":
        return transducer_fwd_reference(blank_lp, label_lp, t_lens,
                                        u_lens)[0]
    return _TransducerLoss.apply(blank_lp, label_lp, t_lens, u_lens)
