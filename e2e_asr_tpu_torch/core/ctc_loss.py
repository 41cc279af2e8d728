"""CTC loss (port of optax.ctc_loss, which the JAX package calls in
models/ctc.py `loss` and models/hybrid.py `loss`).

The JAX package leaves this loss to XLA (no Pallas kernel), so the port
computes it in plain PyTorch and differentiates it with autograd, on the
card as on the CPU. The recursion is optax's, step for step: the 2N+1
states of the blank-interleaved label sequence kept as N+1 blank states
(phi) and N label states (emit) in log space, log(0) approximated by
`log_epsilon` = -1e5, a repeated label reachable only through a blank, and
frames whose logit padding is 1 leaving the state as it was.

torch.nn.functional.ctc_loss is another function at the edges: it returns
inf where the labels need more frames than the logits give, while this
recursion returns a finite loss there (about -log_epsilon per missing
frame).
"""
from __future__ import annotations

import torch

LOG_EPSILON = -1e5


def _update_phi(phi: torch.Tensor, added: torch.Tensor) -> torch.Tensor:
    """phi[:, 1:] logaddexp'd with `added`; phi[:, 0] as it was."""
    return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)], dim=1)


def ctc_loss(logits: torch.Tensor, logit_paddings: torch.Tensor,
             labels: torch.Tensor, label_paddings: torch.Tensor,
             blank_id: int = 0, log_epsilon: float = LOG_EPSILON
             ) -> torch.Tensor:
    """Per-sequence CTC negative log-likelihood [B].

    logits [B, T, K] (log-softmaxed here); logit_paddings [B, T], 1.0 at
    padded frames; labels [B, N] int, right-padded; label_paddings [B, N],
    1.0 at padded labels. Arguments and result as optax.ctc_loss's."""
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    B, T, _ = logprobs.shape
    N = labels.shape[1]
    labels = labels.long()
    label_lens = N - label_paddings.sum(dim=1).long()
    # repeat[b, n] = 1 where labels[b, n] == labels[b, n + 1]; the
    # epsilon move from emit to phi takes log_epsilon there, the blank
    # move log_epsilon elsewhere.
    repeat = torch.nn.functional.pad(
        (labels[:, :-1] == labels[:, 1:]).float(), (0, 1))
    eps_move = log_epsilon * repeat
    blank_move = log_epsilon * (1.0 - repeat)
    lp_phi = logprobs[:, :, blank_id].transpose(0, 1)[:, :, None]  # [T,B,1]
    lp_emit = torch.gather(logprobs, 2, labels[:, None, :].expand(
        B, T, N)).transpose(0, 1)                                  # [T,B,N]
    # A padded frame keeps the state (optax's pad * old + (1 - pad) * new
    # with pad in {0, 1}: the same values and gradients).
    pads = (logit_paddings.transpose(0, 1) > 0.5)[:, :, None]      # [T,B,1]
    dev = logprobs.device
    phi = torch.full((B, N + 1), log_epsilon, device=dev)
    phi = torch.cat([torch.zeros(B, 1, device=dev), phi[:, 1:]], dim=1)
    emit = torch.full((B, N), log_epsilon, device=dev)
    for t in range(T):
        prev_phi = _update_phi(phi, emit + eps_move)
        # phi-to-emit, and the emit self-loop.
        next_emit = torch.logaddexp(prev_phi[:, :-1], emit) + lp_emit[t]
        # phi self-loop; emit-to-phi by a blank only where the next label
        # repeats (elsewhere the epsilon move above took it).
        next_phi = _update_phi(prev_phi, emit + blank_move) + lp_phi[t]
        emit = torch.where(pads[t], emit, next_emit)
        phi = torch.where(pads[t], phi, next_phi)
    last = _update_phi(phi, emit)
    return -torch.gather(last, 1, label_lens[:, None])[:, 0]


def ctc_loss_mean(logits: torch.Tensor, enc_lens: torch.Tensor,
                  labels: torch.Tensor, label_lens: torch.Tensor,
                  blank_id: int = 0) -> torch.Tensor:
    """The mean CTC loss of the models: logits [B, T, V] valid up to
    enc_lens [B], labels [B, L] (token ids, 0-padded, no <go>/<eos>)
    valid up to label_lens [B] (models/ctc.py `loss`)."""
    T, L = logits.shape[1], labels.shape[1]
    dev = logits.device
    logit_pad = (torch.arange(T, device=dev)[None, :]
                 >= enc_lens.to(dev).long()[:, None]).float()
    label_pad = (torch.arange(L, device=dev)[None, :]
                 >= label_lens.to(dev).long()[:, None]).float()
    return ctc_loss(logits, logit_pad, labels, label_pad,
                    blank_id=blank_id).mean()
