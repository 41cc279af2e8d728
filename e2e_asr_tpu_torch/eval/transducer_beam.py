"""Transducer beam search, batched with fixed shapes (port of
e2e_asr_tpu/eval/transducer_beam.py).

Time-synchronous decoding with a limited number of expansion rounds per
frame: at every encoder frame each of the k hypotheses either takes blank
(finishing the frame) or emits a label and may expand again, up to
`max_expansions` rounds; after the last round the surviving unfinished
hypotheses are forced through blank. Beams live in [B, k, ...] tensors and
every selection is the top k of the k stay-candidates and the k*V
extensions, ties to the lower index (the reference's lax.top_k; a stable
descending sort here, since torch.topk on CUDA promises no tie order).
Hypotheses reached through different alignments are not merged, as in the
reference. The joint and the prediction network's steps are plain PyTorch
(the reference computes them outside any Pallas kernel); the encoder runs
on its kernels.

Not ported (NotImplementedError naming the ROADMAP.md item): RNN-LM
shallow fusion, internal-LM subtraction and contextual biasing ('Decode
features').
"""
from __future__ import annotations

import torch

from e2e_asr_tpu_torch.config import BeamConfig, Seq2SeqConfig
from e2e_asr_tpu_torch.core.layers import dense
from e2e_asr_tpu_torch.models import seq2seq, transducer
from e2e_asr_tpu_torch.models.transducer import (BLANK_ID, _pred_step,
                                                 _select, init_decode_state)

NEG_INF = -1e30


def check_supported(*, lm_params=None, lm_weight: float = 0.0,
                    ilm_weight: float = 0.0, bias=None,
                    compute_dtype=None) -> None:
    todo = "is not ported yet (ROADMAP.md Queue 1, 'Decode features')"
    for bad, name in (
            (lm_params is not None or lm_weight != 0.0,
             "transducer RNN-LM fusion"),
            (ilm_weight != 0.0, "transducer internal-LM subtraction"),
            (bias is not None, "transducer contextual biasing"),
            (compute_dtype is not None, "bf16 compute")):
        if bad:
            raise NotImplementedError(f"{name} {todo}")


def _gather_beam(tree, parent: torch.Tensor):
    """Reindex [B, k, ...] leaves by parent [B, k]."""
    if isinstance(tree, torch.Tensor):
        idx = parent.reshape(parent.shape + (1,) * (tree.ndim - 2))
        return torch.gather(tree, 1, idx.expand(parent.shape
                                                + tree.shape[2:]))
    items = [_gather_beam(x, parent) for x in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


@torch.no_grad()
def transducer_beam_decode(params: dict, cfg: Seq2SeqConfig,
                           enc: torch.Tensor, enc_lens: torch.Tensor, *,
                           beam_size: int = 8, max_expansions: int = 3,
                           compute_dtype=None, max_output: int | None = None,
                           lm_params=None, lm_weight: float = 0.0,
                           ilm_weight: float = 0.0, bias=None):
    """Beam search over encoder states enc [B, T_enc, H], enc_lens [B].

    Returns (tokens [B, k, cap] int32, 0-padded in emission order; lens
    [B, k] int32; scores [B, k], the alignment log-probs), beams sorted
    best-first (a stable sort: ties keep the lower beam first).
    """
    check_supported(lm_params=lm_params, lm_weight=lm_weight,
                    ilm_weight=ilm_weight, bias=bias,
                    compute_dtype=compute_dtype)
    k = beam_size
    cap = max_output or cfg.decoders["char"].max_output
    joint = params["joint"]
    enc_proj = dense(joint["enc_proj"], enc)
    B, T, _ = enc_proj.shape
    V = joint["out"]["bias"].shape[0]
    dev = enc_proj.device
    b_idx = torch.arange(B, device=dev)[:, None]
    k_idx = torch.arange(k, device=dev)[None, :]

    # Beam 0 = the empty hypothesis after consuming <go>; the rest dead.
    states0, pred_p0 = init_decode_state(params, cfg, (B, k), device=dev)
    score0 = torch.full((B, k), NEG_INF, device=dev)
    score0[:, 0] = 0.0
    carry = (score0, torch.zeros(B, k, cap, dtype=torch.long, device=dev),
             torch.zeros(B, k, dtype=torch.long, device=dev), states0,
             pred_p0)

    def expand_round(c, enc_t, frame_done, force_blank: bool):
        """One selection round within a frame. frame_done marks hyps that
        already took blank this frame (their only move is to stay)."""
        score, tokens, n, states, pred_p = c
        lp = torch.log_softmax(dense(joint["out"], torch.tanh(
            enc_t[:, None, :] + pred_p)).float(), dim=-1)        # [B, k, V]
        stay = torch.where(frame_done, score, score + lp[..., BLANK_ID])
        if force_blank:
            ext = torch.full((B, k, V), NEG_INF, device=dev)
        else:
            ext = score[:, :, None] + lp
            ext[:, :, BLANK_ID] = NEG_INF
            ext = torch.where((n >= cap)[:, :, None], NEG_INF, ext)
        cand = torch.cat([stay, ext.reshape(B, k * V)], dim=1)
        vals, idx = torch.sort(cand, dim=1, descending=True, stable=True)
        vals, idx = vals[:, :k], idx[:, :k]
        is_stay = idx < k
        parent = torch.where(is_stay, idx, torch.div(
            idx - k, V, rounding_mode="floor"))
        token = torch.where(is_stay, 0, (idx - k) % V)
        tokens, n, states, pred_p = _gather_beam((tokens, n, states, pred_p),
                                                 parent)
        new_done = torch.gather(frame_done, 1, parent) | is_stay
        pos = n.clamp(0, cap - 1)
        tokens = tokens.clone()
        tokens[b_idx, k_idx, pos] = torch.where(
            is_stay, tokens[b_idx, k_idx, pos], token)
        n = n + (~is_stay).long()
        out, new_states = _pred_step(params["pred"], cfg, token, states)
        states = _select(~is_stay, new_states, states)
        pred_p = _select(~is_stay, dense(joint["pred_proj"], out), pred_p)
        return (vals, tokens, n, states, pred_p), new_done

    valid_seq = (torch.arange(T, device=dev)[None, :]
                 < enc_lens.to(dev).long()[:, None])              # [B, T]
    for t in range(T):
        enc_t = enc_proj[:, t]
        c = carry
        frame_done = torch.zeros(B, k, dtype=torch.bool, device=dev)
        for _ in range(max_expansions):
            c, frame_done = expand_round(c, enc_t, frame_done, False)
        # Surviving unfinished hypotheses must take blank to move to t+1.
        c, _ = expand_round(c, enc_t, frame_done, True)
        carry = _select(valid_seq[:, t], c, carry)

    score, tokens, n, _, _ = carry
    order = torch.sort(-score, dim=1, stable=True).indices
    tokens = torch.gather(tokens, 1, order[:, :, None].expand_as(tokens))
    return (tokens.int(), torch.gather(n, 1, order).int(),
            torch.gather(score, 1, order))


@torch.no_grad()
def transducer_beam_search(params: dict, cfg: Seq2SeqConfig,
                           feats: torch.Tensor, feat_lens: torch.Tensor, *,
                           beam_size: int = 8, max_expansions: int = 3,
                           compute_dtype=None, **unported):
    """End-to-end: encoder + transducer beam. Returns the best
    hypothesis's (tokens [B, cap], lens [B])."""
    check_supported(compute_dtype=compute_dtype, **unported)
    attn_states, _, enc_lens = seq2seq.encode(params, cfg, feats, feat_lens)
    depth = cfg.num_layers["char"]
    seqs, lens, _ = transducer_beam_decode(
        params, cfg, attn_states[depth], enc_lens[depth],
        beam_size=beam_size, max_expansions=max_expansions)
    return seqs[:, 0], lens[:, 0]


def make_decoder(cfg: Seq2SeqConfig, beam_cfg: BeamConfig, *,
                 compute_dtype=None, lm_params=None, bias=None):
    """decode(params, batch) -> (tokens [B, cap], lens [B], scores [B]) for
    the transducer family (the serving engine's decode): greedy at beam
    size 1 (scores 0), beam search above. batch: {"logmel": [B, T, feat],
    "logmel_len": [B]} as numpy arrays or tensors; they are moved to the
    device of the parameters."""
    check_supported(lm_params=lm_params, lm_weight=beam_cfg.lm_weight,
                    ilm_weight=beam_cfg.ilm_weight, bias=bias,
                    compute_dtype=compute_dtype)
    if beam_cfg.lm_rescore != 0.0:
        raise NotImplementedError("transducer lm_rescore is not ported yet "
                                  "(ROADMAP.md Queue 1, 'Decode features')")
    k = beam_cfg.beam_size
    depth = cfg.num_layers["char"]

    @torch.no_grad()
    def decode(params, batch):
        dev = params["joint"]["out"]["kernel"].device
        feats = torch.as_tensor(batch["logmel"], dtype=torch.float32,
                                device=dev)
        feat_lens = torch.as_tensor(batch["logmel_len"], device=dev)
        if k <= 1:
            tokens = transducer.greedy_decode(params, cfg, feats, feat_lens)
            return (tokens, (tokens != 0).sum(-1).int(),
                    torch.zeros(tokens.shape[0], device=dev))
        attn_states, _, enc_lens = seq2seq.encode(params, cfg, feats,
                                                  feat_lens)
        seqs, lens, scores = transducer_beam_decode(
            params, cfg, attn_states[depth], enc_lens[depth], beam_size=k)
        return seqs[:, 0], lens[:, 0], scores[:, 0]

    return decode
