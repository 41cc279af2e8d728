"""CTC prefix scoring for one-pass joint CTC/attention beam decoding (port
of e2e_asr_tpu/eval/ctc_prefix.py).

During the attention beam search every candidate extension g·c is also
scored with the CTC prefix probability psi(g·c) = log P_ctc(the collapsed
output begins with g·c | X), computed incrementally from each
hypothesis's forward variables r^n_t(g) (g emitted, ending in a non-blank
at frame t) and r^b_t(g) (ending in a blank), and the beam ranks
(1 - w) * log p_att + w * (psi(g·c) - psi(g)). The <eos> candidate takes
the complete-sequence probability lse(r^n_T(g), r^b_T(g)) instead, so
finishing competes fairly with continuing.

Every hypothesis carries r^n / r^b as dense [T] vectors ([B, k, T]); one
launch of kernel #16 (kernels/ctc_prefix.py `prefix_scan`; its plain
version on the CPU) runs the frame recurrence of all candidate extensions
of all hypotheses at once ([B*k, P] chains, P the candidate count). For a
large vocabulary the candidates are pre-pruned to the attention
decoder's top P = max(pre_beam, k) tokens (ESPnet's pre-beam), everything
else scoring NEG_INF.
"""
from __future__ import annotations

import torch

from e2e_asr_tpu_torch.data.text import EOS_ID
from e2e_asr_tpu_torch.kernels import ctc_prefix

NEG_INF = ctc_prefix.NEG_INF
_lse = ctc_prefix._lse


class CTCPrefixScorer:
    """Batched incremental CTC prefix scorer over [B, T, V] frame logits.

    Construct once per utterance batch and thread its dict states through
    the beam loop:

        state = scorer.init_state(k)
        delta, cand = scorer.step(state, att_logp)   # [B, k, V] deltas
        state = scorer.select(cand, parent, token)
    """

    def __init__(self, ctc_logits: torch.Tensor, enc_lens: torch.Tensor, *,
                 blank_id: int = 0, eos_id: int = EOS_ID,
                 pre_beam: int | None = None):
        B, T, V = ctc_logits.shape
        dev = ctc_logits.device
        lp = torch.log_softmax(ctc_logits.float(), dim=-1)
        lens = enc_lens.to(dev).long()
        valid = torch.arange(T, device=dev)[None, :] < lens[:, None]
        # Frames past each utterance's length contribute nothing anywhere.
        self.lp = torch.where(valid[:, :, None], lp, NEG_INF)
        self.lp_blank = self.lp[:, :, blank_id]                # [B, T]
        self.last_t = (lens - 1).clamp_min(0)
        self.blank_id = blank_id
        self.eos_id = eos_id
        self.pre_beam = pre_beam
        self.B, self.T, self.V = B, T, V

    def init_state(self, k: int) -> dict:
        B, T = self.B, self.T
        dev = self.lp.device
        # The empty prefix can only have emitted blanks so far.
        rb_empty = torch.cumsum(self.lp_blank, dim=1)          # [B, T]
        return {"rn": torch.full((B, k, T), NEG_INF, device=dev),
                "rb": rb_empty[:, None, :].expand(B, k, T).contiguous(),
                "psi": torch.zeros(B, k, device=dev),
                "last": torch.full((B, k), -1, dtype=torch.int32,
                                   device=dev)}

    def candidates(self, att_logp: torch.Tensor) -> torch.Tensor:
        """The candidate tokens [B, k, P] of each hypothesis: every token,
        or the attention's top P = max(pre_beam, k) when that is below V
        (ordered, ties to the lower id, as lax.top_k)."""
        B, k, V = att_logp.shape
        P = V if self.pre_beam is None else min(V, max(self.pre_beam, k))
        if P < V:
            order = torch.sort(att_logp, dim=-1, descending=True,
                               stable=True).indices
            return order[:, :, :P]
        return torch.arange(V, device=att_logp.device).expand(B, k, V)

    def scan_inputs(self, state: dict, att_logp: torch.Tensor):
        """(cand [B, k, P], the arguments of kernel #16's prefix_scan for
        this step: xc [T, B*k, P], xb, rn_par, rb_par [T, B*k, 1],
        allow_neg and phi0 [B*k, P], contiguous)."""
        B, T, V = self.B, self.T, self.V
        k = att_logp.shape[1]
        cand = self.candidates(att_logp)                       # [B, k, P]
        P = cand.shape[-1]
        last = state["last"]
        allow_neg = torch.where(cand != last[:, :, None], 0.0, NEG_INF)
        phi0 = torch.where(last < 0, 0.0, NEG_INF)[:, :, None].expand(
            B, k, P)
        # The candidates' emissions at every frame, gathered in one go.
        xc = torch.gather(self.lp.transpose(1, 2)[:, None].expand(B, k, V, T),
                          2, cand[..., None].expand(B, k, P, T))
        xb = self.lp_blank.t()[:, :, None].expand(T, B, k)
        args = (xc.permute(3, 0, 1, 2).reshape(T, B * k, P),
                xb.reshape(T, B * k, 1),
                state["rn"].permute(2, 0, 1).reshape(T, B * k, 1),
                state["rb"].permute(2, 0, 1).reshape(T, B * k, 1),
                allow_neg.reshape(B * k, P), phi0.reshape(B * k, P))
        return cand, tuple(a.contiguous() for a in args)

    def step(self, state: dict, att_logp: torch.Tensor):
        """Score every candidate extension of every hypothesis.

        state: the per-hypothesis scorer state ([B, k, ...] leaves);
        att_logp [B, k, V]: the attention log-probs, read only to pick the
        pre-beam candidates.
        Returns (delta [B, k, V]: psi(g·c) - psi(g) per candidate, NEG_INF
        for non-candidates and blank, the complete-sequence delta at
        <eos>; the candidates' state for `select`)."""
        B, T, V = self.B, self.T, self.V
        k = att_logp.shape[1]
        cand, args = self.scan_inputs(state, att_logp)
        P = cand.shape[-1]
        psi_f, rn_tm, rb_tm = ctc_prefix.prefix_scan(*args)
        psi_f = psi_f.view(B, k, P)

        psi_prev = state["psi"][:, :, None]
        bad = torch.minimum(psi_f, psi_prev) < NEG_INF / 2
        delta_c = torch.where(bad, NEG_INF, psi_f - psi_prev)
        if P < V:
            delta = torch.full((B, k, V), NEG_INF, device=delta_c.device)
            delta.scatter_(2, cand, delta_c)
        else:
            delta = delta_c

        # <eos>: the hypothesis ends; score the COMPLETE CTC probability.
        t_idx = self.last_t[:, None, None].expand(B, k, 1)
        total = _lse(torch.gather(state["rn"], 2, t_idx)[:, :, 0],
                     torch.gather(state["rb"], 2, t_idx)[:, :, 0])
        psi_prev = state["psi"]
        bad_eos = torch.minimum(total, psi_prev) < NEG_INF / 2
        delta[:, :, self.eos_id] = torch.where(bad_eos, NEG_INF,
                                               total - psi_prev)
        # Blank is a CTC transition, not a label: never an extension.
        delta[:, :, self.blank_id] = NEG_INF

        cand_state = {"rn": rn_tm.view(T, B, k, P).permute(1, 2, 3, 0),
                      "rb": rb_tm.view(T, B, k, P).permute(1, 2, 3, 0),
                      "psi": psi_f, "cand": cand}
        return delta, cand_state

    def select(self, cand_state: dict, parent: torch.Tensor,
               token: torch.Tensor) -> dict:
        """Advance to the selected (parent, token) of each new beam slot
        (the first position of the token in the parent's candidates).
        Slots whose token is not among their parent's candidates (dead or
        finished slots) get unspecified values; the beam never reads
        them."""
        parent = parent.long()
        b_idx = torch.arange(parent.shape[0], device=parent.device)[:, None]
        cand_par = cand_state["cand"][b_idx, parent]           # [B, k, P]
        pos = torch.argmax((cand_par == token[:, :, None]).to(torch.int32),
                           dim=-1)
        pick = lambda a: a[b_idx, parent, pos]  # noqa: E731
        return {"rn": pick(cand_state["rn"]), "rb": pick(cand_state["rb"]),
                "psi": pick(cand_state["psi"]).clamp_min(NEG_INF),
                "last": token.to(torch.int32)}
