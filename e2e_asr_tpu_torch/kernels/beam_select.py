"""Kernel D: one beam-search selection step (`csrc/beam_select.cu`).

Replaces: e2e_asr_tpu/ops/beam_select_pallas.py `beam_select`.

Computes, per batch row: the top-k of the k*V candidates
scores[p] + logp[p, v] over live parents (dead parents are exactly
NEG_INF = -1e30), ties to the lowest flat index as lax.top_k; acceptance
rank < k - num_finished; the finished-buffer slot of each accepted <eos>
(k = dropped); and the stable live-first compaction order.

Bound on the H100: launch latency. The serving shape (B=8, k=4, V=40) is
160 candidates per row, a few hundred instructions; the plain version is
about fifteen small operations, one launch each.

Design: one launch, one warp per batch row; the candidates in shared
memory with a taken flag each, k rounds of a strided scan plus a shuffle
argmax over the untaken ones (so a row of -inf or NaN still yields k valid
indices, NaN ranking first as in the plain version's sort), and lane 0
doing the O(k) integer bookkeeping. No vocabulary padding: the 128-lane padding of
the TPU kernel does not change which (parent, token) pairs win.
"""
from __future__ import annotations

import torch

from e2e_asr_tpu_torch.kernels import build

NEG_INF = -1e30
LAUNCHES = 0
_OUT_DTYPES = {"vals": torch.float32, "parent": torch.int32,
               "token": torch.int32, "accept": torch.float32,
               "fin_sel": torch.float32, "fin_dest": torch.int32,
               "order": torch.int32, "slot_valid": torch.float32}


def beam_select_reference(scores, logp, alive, num_finished, *,
                          eos_id: int = 2) -> dict:
    """Plain PyTorch version of the kernel: same arguments and results."""
    B, k, V = logp.shape
    cand = torch.where(alive[:, :, None], scores[:, :, None] + logp,
                       torch.full_like(logp, NEG_INF)).reshape(B, k * V)
    # Stable descending sort: equal values keep ascending flat index.
    vals, flat_idx = torch.sort(cand, dim=1, descending=True, stable=True)
    vals, flat_idx = vals[:, :k], flat_idx[:, :k]
    parent, token = flat_idx // V, flat_idx % V
    nf = num_finished.long()
    accept = torch.arange(k, device=logp.device)[None, :] < (k - nf)[:, None]
    is_eos = token == eos_id
    fin_sel = accept & is_eos
    live_sel = accept & ~is_eos
    fin_rank = torch.cumsum(fin_sel.long(), dim=1) - 1
    fin_dest = torch.where(fin_sel, nf[:, None] + fin_rank,
                           torch.full_like(fin_rank, k))
    order = torch.sort((~live_sel).long(), dim=1, stable=True).indices
    slot_valid = torch.gather(live_sel, 1, order)
    out = dict(vals=vals, parent=parent, token=token, accept=accept,
               fin_sel=fin_sel, fin_dest=fin_dest, order=order,
               slot_valid=slot_valid)
    return {key: out[key].to(dt) for key, dt in _OUT_DTYPES.items()}


def beam_select(scores, logp, alive, num_finished, *, eos_id: int = 2
                ) -> dict:
    """Fused selection. scores [B,k] f32, logp [B,k,V] f32, alive [B,k]
    bool, num_finished [B] int32. Returns a dict of [B,k] arrays: vals,
    parent, token, accept, fin_sel, fin_dest, order, slot_valid (float
    masks are 1.0/0.0; parent, token, fin_dest, order are int32)."""
    global LAUNCHES
    if logp.device.type == "cpu":
        return beam_select_reference(scores, logp, alive, num_finished,
                                     eos_id=eos_id)
    if logp.device.type != "cuda":
        raise ValueError(f"beam_select: unsupported device {logp.device}")
    dev = logp.device
    B, k, V = logp.shape
    build.require(scores, "scores", torch.float32, (B, k), dev)
    build.require(logp, "logp", torch.float32, (B, k, V), dev)
    build.require(alive, "alive", torch.bool, (B, k), dev)
    build.require(num_finished, "num_finished", torch.int32, (B,), dev)
    flat = {}
    for dt in (torch.float32, torch.int32):
        keys = [key for key, d in _OUT_DTYPES.items() if d == dt]
        parts = torch.empty(len(keys), B, k, dtype=dt, device=dev)
        flat.update(zip(keys, parts.unbind(0)))
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.e2e_beam_select(
            scores.data_ptr(), logp.data_ptr(), alive.data_ptr(),
            num_finished.data_ptr(), B, k, V, eos_id,
            *[flat[key].data_ptr() for key in _OUT_DTYPES],
            build.stream_ptr(dev))
    build.check(err, "beam_select")
    LAUNCHES += 1
    return {key: flat[key] for key in _OUT_DTYPES}
