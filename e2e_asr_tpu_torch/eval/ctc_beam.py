"""CTC prefix beam search, batched with fixed shapes (port of
e2e_asr_tpu/eval/ctc_beam.py without its LM fusion and biasing).

The standard prefix beam search (Hannun et al. 2014): each beam slot holds
a prefix with separate log-masses for "ends in blank" (p_b) and "ends in a
non-blank" (p_nb); at each frame every prefix is (a) kept, by a blank or a
repeat of its last token (which collapses), and (b) extended by every
non-blank token (a repeat of the last token only from the blank-ending
mass), and the top k of the k + k*V candidates survive (ordered, ties to
the lower index, as lax.top_k). Prefixes live in a [B, k, T] buffer;
frames past an utterance's length leave its state as it was. As in the
reference, equal prefixes reached through different parents are not
merged during the search.

Plain PyTorch over a frame loop: the JAX package has no kernel here.
RNN-LM shallow fusion (`lm_params` / `lm_weight`) and contextual biasing
(`bias`) raise NotImplementedError naming ROADMAP.md's 'Decode features'.
"""
from __future__ import annotations

import torch

from e2e_asr_tpu_torch.config import BeamConfig, Seq2SeqConfig
from e2e_asr_tpu_torch.kernels.ctc_prefix import NEG_INF, _lse
from e2e_asr_tpu_torch.models import ctc


def check_supported(*, lm_params=None, lm_weight: float = 0.0, bias=None,
                    lm_rescore: float = 0.0) -> None:
    todo = "is not ported yet (ROADMAP.md Queue 1, 'Decode features')"
    for bad, name in ((lm_params is not None or lm_weight != 0.0,
                       "CTC RNN-LM fusion"),
                      (lm_rescore != 0.0, "CTC lm_rescore"),
                      (bias is not None, "CTC contextual biasing")):
        if bad:
            raise NotImplementedError(f"{name} {todo}")


def _top_k(x: torch.Tensor, k: int):
    """lax.top_k over the last axis: (values, indices), descending, ties
    to the lower index."""
    order = torch.sort(x, dim=-1, descending=True, stable=True).indices
    idx = order[..., :k]
    return torch.gather(x, -1, idx), idx


@torch.no_grad()
def ctc_beam_decode(log_probs: torch.Tensor, lens: torch.Tensor, *,
                    beam_size: int = 8, blank_id: int = 0, lm_params=None,
                    lm_weight: float = 0.0, bias=None):
    """Prefix beam search over per-frame log-probs.

    log_probs [B, T, V] log-softmaxed frame posteriors; lens [B] valid
    frame counts. Returns (prefixes [B, k, T] int32 0-padded, prefix
    lengths [B, k] int32, scores [B, k] total log-mass), best first."""
    check_supported(lm_params=lm_params, lm_weight=lm_weight, bias=bias)
    B, T, V = log_probs.shape
    k = beam_size
    dev = log_probs.device
    seqs = torch.zeros(B, k, T, dtype=torch.int32, device=dev)
    seq_lens = torch.zeros(B, k, dtype=torch.int32, device=dev)
    # Slot 0 is the empty prefix with certainty; the rest are dead.
    pb = torch.full((B, k), NEG_INF, device=dev)
    pb[:, 0] = 0.0
    pnb = torch.full((B, k), NEG_INF, device=dev)
    last = torch.full((B, k), -1, dtype=torch.long, device=dev)
    valid_seq = (torch.arange(T, device=dev)[None, :]
                 < lens.to(dev).long()[:, None])
    b_idx = torch.arange(B, device=dev)[:, None].expand(B, k)
    ranks = torch.arange(k, device=dev)[None, :].expand(B, k)
    vocab = torch.arange(V, device=dev)
    for t in range(T):
        lp = log_probs[:, t].float()                           # [B, V]
        lp_last = torch.gather(lp, 1, last.clamp_min(0))       # [B, k]
        total = _lse(pb, pnb)
        # (a) keep the prefix: a blank after anything, or a repeat.
        pb_stay = total + lp[:, blank_id][:, None]
        pnb_stay = torch.where(last >= 0, pnb + lp_last, NEG_INF)
        stay = _lse(pb_stay, pnb_stay)
        # (b) extend by v != blank; a repeat of `last` only from p_b.
        base = torch.where(vocab[None, None, :] == last[:, :, None],
                           pb[:, :, None], total[:, :, None])
        ext = base + lp[:, None, :]                            # [B, k, V]
        ext[:, :, blank_id] = NEG_INF
        ext = ext.reshape(B, k * V)
        _, idx = _top_k(torch.cat([stay, ext], dim=1), k)
        is_stay = idx < k
        ext_idx = (idx - k).clamp_min(0)
        parent = torch.where(is_stay, idx, ext_idx // V)
        token = torch.where(is_stay, 0, ext_idx % V)

        def g(a):
            return torch.gather(a, 1, parent)

        new_seqs = seqs[b_idx, parent]                         # [B, k, T]
        p_lens = g(seq_lens)
        ext_seqs = new_seqs.clone()
        ext_seqs[b_idx, ranks, p_lens.long()] = token.int()
        new_pb = torch.where(is_stay, g(pb_stay), NEG_INF)
        new_pnb = torch.where(is_stay, g(pnb_stay),
                              torch.gather(ext, 1, ext_idx))
        new_last = torch.where(is_stay, g(last), token)
        new_lens = torch.where(is_stay, p_lens, p_lens + 1)
        new_seqs = torch.where(is_stay[:, :, None], new_seqs, ext_seqs)
        # Past each utterance's length the state is frozen.
        keep = valid_seq[:, t][:, None]
        seqs = torch.where(keep[:, :, None], new_seqs, seqs)
        seq_lens = torch.where(keep, new_lens, seq_lens)
        pb = torch.where(keep, new_pb, pb)
        pnb = torch.where(keep, new_pnb, pnb)
        last = torch.where(keep, new_last, last)
    scores = _lse(pb, pnb)
    order = torch.argsort(-scores, dim=1, stable=True)
    return (seqs[b_idx, order], torch.gather(seq_lens, 1, order),
            torch.gather(scores, 1, order))


@torch.no_grad()
def ctc_beam_search(params: dict, cfg: Seq2SeqConfig, feats: torch.Tensor,
                    feat_lens: torch.Tensor, *, beam_size: int = 8,
                    compute_dtype=None, lm_params=None,
                    lm_weight: float = 0.0, bias=None):
    """End-to-end: the encoder, the CTC head and the prefix beam search.
    Returns (tokens [B, T_enc] of the best prefix, its length [B])."""
    check_supported(lm_params=lm_params, lm_weight=lm_weight, bias=bias)
    lg, enc_lens = ctc.logits(params, cfg, feats, feat_lens,
                              compute_dtype=compute_dtype)
    seqs, lens, _ = ctc_beam_decode(torch.log_softmax(lg, dim=-1), enc_lens,
                                    beam_size=beam_size,
                                    blank_id=ctc.BLANK_ID)
    return seqs[:, 0], lens[:, 0]


def make_decoder(cfg: Seq2SeqConfig, beam_cfg: BeamConfig, *,
                 compute_dtype=None, lm_params=None, bias=None):
    """decode(params, batch) -> (tokens [B, T_enc], lens [B], scores [B])
    for the CTC family (the serving engine's decode): best path at beam
    size 1 (scores 0), the prefix beam search above. batch: {"logmel":
    [B, T, feat], "logmel_len": [B]} as numpy arrays or tensors; they are
    moved to the device of the parameters."""
    check_supported(lm_params=lm_params, lm_weight=beam_cfg.lm_weight,
                    bias=bias, lm_rescore=beam_cfg.lm_rescore)
    if beam_cfg.ilm_weight != 0.0:
        raise ValueError("ilm_weight needs a decoder-bearing family "
                         "(attention/transducer); pure CTC has no internal "
                         "LM to subtract")
    ctc._check_dtype(compute_dtype)
    k = beam_cfg.beam_size

    @torch.no_grad()
    def decode(params, batch):
        dev = params["ctc_head"]["kernel"].device
        feats = torch.as_tensor(batch["logmel"], dtype=torch.float32,
                                device=dev)
        feat_lens = torch.as_tensor(batch["logmel_len"], device=dev)
        if k <= 1:
            tokens = ctc.greedy_decode(params, cfg, feats, feat_lens)
            return (tokens, (tokens != 0).sum(-1).int(),
                    torch.zeros(tokens.shape[0], device=dev))
        lg, enc_lens = ctc.logits(params, cfg, feats, feat_lens)
        seqs, lens, scores = ctc_beam_decode(
            torch.log_softmax(lg, dim=-1), enc_lens, beam_size=k,
            blank_id=ctc.BLANK_ID)
        return seqs[:, 0], lens[:, 0], scores[:, 0]

    return decode
