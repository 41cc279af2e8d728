"""RNN-T (transducer) loss on the (T, U+1) lattice (port of
e2e_asr_tpu/core/transducer_loss.py): the negative log-likelihood of each
label sequence, marginalized over all monotonic alignments of its U labels
to the T encoder frames (Graves 2012, arXiv:1211.3711).

`transducer_loss` takes the two per-node log-probability lattices (blank,
and emit-the-next-label), not the full [B, T, U+1, V] joint. CUDA tensors
go through kernel #17's forward and backward (kernels/transducer.py); CPU
tensors through its plain forward, differentiated by autograd. The
reference's `impl` switch is gone: nothing sends CUDA tensors to the plain
version.

`transducer_loss_reference` is the O(T*U) double-loop oracle, kept for
tests.
"""
from __future__ import annotations

import numpy as np
import torch

from e2e_asr_tpu_torch.kernels import transducer as kernel

NEG = kernel.NEG  # effective log(0); finite so (-inf) - (-inf) never appears


def transducer_loss(blank_lp: torch.Tensor, label_lp: torch.Tensor,
                    t_lens: torch.Tensor, u_lens: torch.Tensor
                    ) -> torch.Tensor:
    """Negative log-likelihood of the label sequences, per example.

    blank_lp: [B, T, U+1], log P(blank | t, u) at each lattice node;
    label_lp: [B, T, U], log P(labels[u] | t, u) (emit the NEXT label);
    t_lens, u_lens: [B] true encoder lengths and label counts.

    Returns [B] float32: -log P(labels | acoustics), with alpha[0,0] = 0,
    alpha[t,u] = logaddexp(alpha[t-1,u] + blank_lp[t-1,u],
    alpha[t,u-1] + label_lp[t,u-1]) and loss = -(alpha[T-1,U] +
    blank_lp[T-1,U]) at each example's lengths (clamped to the lattice);
    labels past u_len are masked to log 0.
    """
    return kernel.transducer_loss(blank_lp, label_lp, t_lens, u_lens)


def transducer_loss_reference(blank_lp, label_lp, t_lens, u_lens):
    """O(T*U) double-loop oracle in float64 (same semantics, no scan); for
    tests, not for training. The caller masks labels past u_len."""
    blank_lp = np.asarray(blank_lp, np.float64)
    label_lp = np.asarray(label_lp, np.float64)
    B = blank_lp.shape[0]
    out = np.zeros((B,), np.float64)
    for b in range(B):
        Tb, Ub = int(t_lens[b]), int(u_lens[b])
        alpha = np.full((Tb, Ub + 1), -np.inf)
        alpha[0, 0] = 0.0
        for t in range(Tb):
            for u in range(Ub + 1):
                if t == 0 and u == 0:
                    continue
                cands = []
                if t > 0:
                    cands.append(alpha[t - 1, u] + blank_lp[b, t - 1, u])
                if u > 0:
                    cands.append(alpha[t, u - 1] + label_lp[b, t, u - 1])
                alpha[t, u] = np.logaddexp.reduce(cands)
        out[b] = -(alpha[Tb - 1, Ub] + blank_lp[b, Tb - 1, Ub])
    return out
