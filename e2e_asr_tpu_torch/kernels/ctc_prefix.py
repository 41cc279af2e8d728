"""Kernel #16: the CTC prefix-score frame scan of one joint CTC/attention
beam step (`csrc/ctc_prefix.cu`).

Replaces: e2e_asr_tpu/ops/ctc_prefix_pallas.py `prefix_scan` (body
`_kernel`), which the reference's CTCPrefixScorer.step calls once per beam
step (eval/ctc_prefix.py).

For each row bk and candidate p the four carries (rn, rb, psi, phi) start
at NEG_INF, NEG_INF, NEG_INF and phi0, and each frame t applies
    rn_t = lse(rn, phi) + xc[t]
    rb_t = lse(rb, rn) + xb[t]
    psi  = lse(psi, phi + xc[t])
    phi  = lse(rb_par[t], rn_par[t] + allow_neg)
with the reference's lse (m = max(max(a, b), NEG_INF);
m + log(exp(a - m) + exp(b - m))).

Bound on the H100: latency. At the serving shape (BK = 32, P = 40, T = 64)
the scan moves about 1 MB, a third of a microsecond of memory time, but
each chain is T dependent steps. Design: one thread a chain, its carries
in registers, the next frame's inputs loaded while the current one is
computed (details in the source).

`prefix_scan` launches the kernel for CUDA tensors and takes the plain
version `prefix_scan_reference`, a PyTorch frame loop, for CPU tensors.
"""
from __future__ import annotations

import torch

from e2e_asr_tpu_torch.kernels import build

NEG_INF = -1e30
LAUNCHES = 0


def _lse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.clamp_min(torch.maximum(a, b), NEG_INF)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m))


def prefix_scan_reference(xc, xb, rn_par, rb_par, allow_neg, phi0):
    """Plain PyTorch version of the kernel: the same arguments and results
    (prefix_scan's)."""
    T, BK, P = xc.shape
    neg = torch.full((BK, P), NEG_INF, device=xc.device)
    rn, rb, psi, phi = neg, neg, neg, phi0
    rn_seq, rb_seq = [], []
    for t in range(T):
        rn_t = _lse(rn, phi) + xc[t]
        rb_t = _lse(rb, rn) + xb[t]
        psi = _lse(psi, phi + xc[t])
        phi = _lse(rb_par[t], rn_par[t] + allow_neg)
        rn, rb = rn_t, rb_t
        rn_seq.append(rn_t)
        rb_seq.append(rb_t)
    return psi, torch.stack(rn_seq), torch.stack(rb_seq)


def prefix_scan(xc: torch.Tensor, xb: torch.Tensor, rn_par: torch.Tensor,
                rb_par: torch.Tensor, allow_neg: torch.Tensor,
                phi0: torch.Tensor):
    """The whole T-frame prefix recurrence of one beam step.

    xc [T, BK, P] float32: candidate emission log-probs per frame;
    xb, rn_par, rb_par [T, BK, 1]: the blank log-prob per frame and the
    parent hypothesis's forward variables; allow_neg [BK, P]: 0 where the
    candidate differs from the row's last label, NEG_INF where it repeats
    it; phi0 [BK, P]: the initial phi.
    Returns (psi [BK, P], rn [T, BK, P], rb [T, BK, P]): kernel #16 on CUDA
    tensors, its plain version on CPU tensors."""
    global LAUNCHES
    if xc.device.type == "cpu":
        return prefix_scan_reference(xc, xb, rn_par, rb_par, allow_neg,
                                     phi0)
    dev = xc.device
    if dev.type != "cuda":
        raise ValueError(f"prefix_scan: unsupported device {dev}")
    T, BK, P = xc.shape
    f32 = torch.float32
    req = build.require
    req(xc, "xc", f32, (T, BK, P), dev)
    for t, name in ((xb, "xb"), (rn_par, "rn_par"), (rb_par, "rb_par")):
        req(t, name, f32, (T, BK, 1), dev)
    req(allow_neg, "allow_neg", f32, (BK, P), dev)
    req(phi0, "phi0", f32, (BK, P), dev)
    psi = torch.empty(BK, P, device=dev)
    rn = torch.empty(T, BK, P, device=dev)
    rb = torch.empty(T, BK, P, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.e2e_ctc_prefix_scan(
            xc.data_ptr(), xb.data_ptr(), rn_par.data_ptr(),
            rb_par.data_ptr(), allow_neg.data_ptr(), phi0.data_ptr(),
            psi.data_ptr(), rn.data_ptr(), rb.data_ptr(), T, BK, P,
            build.stream_ptr(dev))
    build.check(err, "prefix_scan")
    LAUNCHES += 1
    return psi, rn, rb
