"""Transducer (RNN-T) model family: encoder + prediction network + joint
(port of e2e_asr_tpu/models/transducer.py).

- the encoder is the attention family's (seq2seq.encode, on its kernels);
- the prediction network is an LSTM stack over <go>-shifted label
  embeddings (cfg.decoders["char"]: emb_size / hidden_size_dec /
  num_layers_dec), each layer on core/rnn.lstm_scan (kernel #3, with #5 as
  its backward);
- the additive joint tanh(enc_proj[t] + pred_proj[u]) -> vocab logits
  (joint_dim wide) is plain PyTorch, as the JAX package leaves it to XLA;
  only the two [B, T, U+1]-shaped log-prob lattices feed the lattice loss
  (core/transducer_loss.py, kernel #17).

Conventions match the CTC family: blank id = 0 (the <pad> slot, never a
real label); labels carry no <go>/<eos> framing. bf16 compute raises.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from e2e_asr_tpu_torch.config import Seq2SeqConfig
from e2e_asr_tpu_torch.core import rnn
from e2e_asr_tpu_torch.core.cells import lstm_init, lstm_step, lstm_zero_state
from e2e_asr_tpu_torch.core.device import resolve
from e2e_asr_tpu_torch.core.layers import (dense, dense_params, dropout,
                                           dropout_mask, uniform_init)
from e2e_asr_tpu_torch.core.transducer_loss import transducer_loss
from e2e_asr_tpu_torch.data import text
from e2e_asr_tpu_torch.models import encoder as encoder_lib
from e2e_asr_tpu_torch.models import seq2seq

BLANK_ID = 0


def _check_dtype(compute_dtype) -> None:
    if compute_dtype is not None:
        raise NotImplementedError("bf16 compute is not ported yet "
                                  "(ROADMAP.md Queue 1, 'Decode features')")


def init(gen: torch.Generator, cfg: Seq2SeqConfig, vocab_size: int, *,
         device=None) -> dict:
    """Encoder + prediction net + joint, laid out (and named) like the JAX
    package's transducer.init, on `device` (default: the CUDA card).
    cfg.num_layers['char'] names the encoder depth whose output feeds the
    joint."""
    device = resolve(device)
    dec = cfg.decoders["char"]
    max_depth = max(cfg.num_layers.values())
    attn_size = cfg.encoder.hidden_size * (2 if cfg.encoder.bi_dir else 1)
    layers = {}
    in_dim = dec.emb_size
    for i in range(dec.num_layers_dec):
        layers[f"layer_{i}"] = lstm_init(gen, in_dim, dec.hidden_size_dec,
                                         device=device)
        in_dim = dec.hidden_size_dec
    return {
        "encoder": encoder_lib.init(gen, cfg.encoder, max_depth,
                                    cfg.feat_length, device=device),
        "pred": {
            "embedding": uniform_init(gen, (vocab_size, dec.emb_size), 1.0,
                                      device=device),
            **layers,
        },
        "joint": {
            "enc_proj": dense_params(gen, attn_size, dec.joint_dim,
                                     device=device),
            "pred_proj": dense_params(gen, dec.hidden_size_dec,
                                      dec.joint_dim, device=device),
            "out": dense_params(gen, dec.joint_dim, vocab_size,
                                device=device),
        },
    }


def pred_states(params: dict, cfg: Seq2SeqConfig, labels: torch.Tensor,
                label_lens: torch.Tensor, *, train: bool = False,
                noise: list | None = None, gen=None) -> torch.Tensor:
    """Teacher-forced prediction-network outputs.

    labels: [B, U] token ids (0-padded). Returns [B, U+1, P] where position
    u is the state after consuming labels[:u] (position 0 has seen only
    <go>). In training, layer i's input dropout takes the bool keep-mask
    noise[i] ([U+1, B, in_dim]) where given, else draws it from `gen`.
    """
    dec = cfg.decoders["char"]
    B = labels.shape[0]
    ids = torch.cat([torch.full((B, 1), text.GO_ID, dtype=labels.dtype,
                                device=labels.device), labels], dim=1)
    x = params["embedding"][ids.long()].transpose(0, 1)     # [U+1, B, E]
    lens = label_lens.to(labels.device).long() + 1
    for i in range(dec.num_layers_dec):
        if train and dec.out_prob_dec < 1.0:
            mask = None if noise is None else noise[i].to(x.device)
            x = dropout(x, dec.out_prob_dec, gen=gen, mask=mask)
        x = rnn.lstm_scan(params[f"layer_{i}"], x, lens)
    return x.transpose(0, 1)                               # [B, U+1, P]


def _joint_chunk(out_params: dict, enc_chunk: torch.Tensor,
                 pred_proj: torch.Tensor, labels: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Joint log-probs for a chunk of frames.

    enc_chunk: [B, c, J]; pred_proj: [B, U+1, J]; labels: [B, U].
    Returns (blank_lp [B, c, U+1], label_lp [B, c, U]) in float32.
    """
    joint = torch.tanh(enc_chunk[:, :, None, :] + pred_proj[:, None, :, :])
    lp = torch.log_softmax(dense(out_params, joint).float(), dim=-1)
    blank_lp = lp[..., BLANK_ID]                               # [B, c, U+1]
    B, c, U = lp.shape[0], lp.shape[1], labels.shape[1]
    idx = labels.long()[:, None, :, None].expand(B, c, U, 1)
    gathered = torch.gather(lp[:, :, :U, :], -1, idx)[..., 0]  # [B, c, U]
    return blank_lp, gathered


# Peak extra bytes one recomputed joint chunk may cost in the backward
# pass: governs the auto-picked t_chunk below (the JAX package's budget).
JOINT_CHUNK_BUDGET = 256 * 1024 * 1024


def _auto_chunk(B: int, T: int, U1: int, V: int, J: int) -> int:
    per_frame = B * U1 * (4 * V + 2 * J)
    return max(1, min(T, JOINT_CHUNK_BUDGET // max(per_frame, 1)))


def lattice_logprobs(params: dict, labels: torch.Tensor, enc: torch.Tensor,
                     pred: torch.Tensor, *, t_chunk: int | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(blank_lp [B,T,U+1], label_lp [B,T,U]) without holding the whole
    [B,T,U+1,V] joint for the backward when it exceeds the budget: frames
    go through in t_chunk-sized blocks, each under
    torch.utils.checkpoint (recomputed in the backward, as jax.checkpoint
    does). t_chunk=None picks the largest chunk whose transient fits
    JOINT_CHUNK_BUDGET; when the whole joint fits, it runs unchunked."""
    joint = params["joint"]
    enc_proj = dense(joint["enc_proj"], enc)
    pred_proj = dense(joint["pred_proj"], pred)
    B, T, J = enc_proj.shape
    if t_chunk is None:
        V = joint["out"]["bias"].shape[0]
        t_chunk = _auto_chunk(B, T, pred.shape[1], V, J)
    if t_chunk >= T:
        return _joint_chunk(joint["out"], enc_proj, pred_proj, labels)
    parts = [torch.utils.checkpoint.checkpoint(
        _joint_chunk, joint["out"], enc_proj[:, s:s + t_chunk], pred_proj,
        labels, use_reentrant=False) for s in range(0, T, t_chunk)]
    return (torch.cat([p[0] for p in parts], dim=1),
            torch.cat([p[1] for p in parts], dim=1))


def train_noise(gen: torch.Generator, cfg: Seq2SeqConfig, U1: int, B: int,
                device) -> list:
    """The prediction network's training dropout keep-masks, one bool
    [U+1, B, in_dim] per layer (empty when out_prob_dec is 1)."""
    dec = cfg.decoders["char"]
    if dec.out_prob_dec >= 1.0:
        return []
    dims = [dec.emb_size] + [dec.hidden_size_dec] * (dec.num_layers_dec - 1)
    return [dropout_mask(gen, (U1, B, d), dec.out_prob_dec, device)
            for d in dims]


def loss(params: dict, cfg: Seq2SeqConfig, batch: dict, *,
         train: bool = False, gen=None, noise: dict | None = None,
         t_chunk: int | None = None, compute_dtype=None) -> torch.Tensor:
    """Mean transducer NLL. batch: logmel/logmel_len plus `labels` [B, U]
    (token ids, 0-padded, no <go>/<eos>) and `label_lens` [B], tensors on
    the parameters' device. noise (training): {"encoder": {depth: bool
    keep-mask}, "pred": [bool keep-mask per layer]}; what it lacks is drawn
    from `gen`. The reference splits its key into the encoder's and the
    prediction network's, whose layer i takes the i-th split."""
    _check_dtype(compute_dtype)
    noise = noise or {}
    attn_states, _, enc_lens = seq2seq.encode(
        params, cfg, batch["logmel"], batch["logmel_len"], train=train,
        gen=gen, drop_masks=noise.get("encoder"))
    depth = cfg.num_layers["char"]
    labels, label_lens = batch["labels"], batch["label_lens"]
    pred = pred_states(params["pred"], cfg, labels, label_lens, train=train,
                       noise=noise.get("pred"), gen=gen)
    blank_lp, label_lp = lattice_logprobs(params, labels, attn_states[depth],
                                          pred, t_chunk=t_chunk)
    per_example = transducer_loss(blank_lp, label_lp, enc_lens[depth],
                                  label_lens)
    return per_example.mean()


def _pred_step(pred_params: dict, cfg: Seq2SeqConfig, token: torch.Tensor,
               states):
    """One prediction-network step. token: [...] ids; states: tuple of
    LSTMState per layer. Returns (top output [..., P], new states)."""
    dec = cfg.decoders["char"]
    x = pred_params["embedding"][token.long()]
    new_states = []
    for i in range(dec.num_layers_dec):
        x, st = lstm_step(pred_params[f"layer_{i}"], x, states[i])
        new_states.append(st)
    return x, tuple(new_states)


def init_decode_state(params: dict, cfg: Seq2SeqConfig, batch, *,
                      device=None, compute_dtype=None):
    """Fresh decode state of `batch` rows (an int or a shape): the
    prediction net after consuming <go>. Returns (LSTM states tuple,
    projected pred output [..., J])."""
    _check_dtype(compute_dtype)
    dec = cfg.decoders["char"]
    shape = (batch,) if isinstance(batch, int) else tuple(batch)
    device = device or params["pred"]["embedding"].device
    states = tuple(lstm_zero_state(shape, dec.hidden_size_dec, device=device)
                   for _ in range(dec.num_layers_dec))
    out, states = _pred_step(params["pred"], cfg, torch.full(
        shape, text.GO_ID, dtype=torch.long, device=device), states)
    return states, dense(params["joint"]["pred_proj"], out)


def _select(mask: torch.Tensor, new, old):
    """new where mask, else old, over two trees (tensors, tuples of
    LSTMStates) whose leaves' leading dims are mask's."""
    if isinstance(new, torch.Tensor):
        m = mask.reshape(mask.shape + (1,) * (new.ndim - mask.ndim))
        return torch.where(m, new, old)
    items = [_select(mask, n, o) for n, o in zip(new, old)]
    return type(new)(*items) if hasattr(new, "_fields") else tuple(items)


# How many decode steps run between two checks of the exit condition: a
# check reads a value back from the device, and extra steps after every
# row is done change nothing.
_EXIT_CHECK_EVERY = 8


@torch.no_grad()
def greedy_decode_states(params: dict, cfg: Seq2SeqConfig,
                         enc: torch.Tensor, enc_lens: torch.Tensor, *,
                         compute_dtype=None, max_symbols_per_frame: int = 4,
                         max_output: int | None = None, init_state=None,
                         return_state: bool = False,
                         return_frames: bool = False):
    """Batched greedy transducer decode from encoder states [B, T_enc, H].

    At frame t each example emits its argmax symbol (advancing only the
    prediction network) until blank or max_symbols_per_frame, then moves to
    t + 1; all examples step together with their own frame and emission
    counters. Returns [B, max_output] token ids in emission order
    (left-packed, 0-padded).

    Streaming: pass the previous chunk's state as init_state (from
    init_decode_state, or a prior return_state=True call) and set
    return_state=True to also get the carry for the next chunk; decoding is
    then exactly one pass over the concatenated encoder states.
    return_frames=True also returns each emission's encoder-frame index
    [B, max_output] (-1 past the emission count).
    """
    _check_dtype(compute_dtype)
    dec = cfg.decoders["char"]
    cap = max_output or dec.max_output
    joint = params["joint"]
    enc_proj = dense(joint["enc_proj"], enc)
    B, T, _ = enc_proj.shape
    dev = enc_proj.device
    b_idx = torch.arange(B, device=dev)
    t_lens = enc_lens.to(dev).long()
    states, pred_p = (init_state if init_state is not None else
                      init_decode_state(params, cfg, B, device=dev))
    t = torch.zeros(B, dtype=torch.long, device=dev)
    n = torch.zeros_like(t)
    emit_n = torch.zeros_like(t)
    tokens = torch.zeros(B, cap, dtype=torch.long, device=dev)
    frames = torch.full((B, cap), -1, dtype=torch.long, device=dev)
    done = t_lens <= 0
    step = 0
    while True:
        if step % _EXIT_CHECK_EVERY == 0 and bool(done.all()):
            break
        step += 1
        t_c = t.clamp(0, T - 1)
        logits = dense(joint["out"], torch.tanh(enc_proj[b_idx, t_c]
                                                + pred_p))
        pick = torch.argmax(logits, dim=-1)
        emit = ((pick != BLANK_ID) & (emit_n < max_symbols_per_frame)
                & (n < cap) & ~done)
        pos = n.clamp(0, cap - 1)
        tokens[b_idx, pos] = torch.where(emit, pick, tokens[b_idx, pos])
        frames[b_idx, pos] = torch.where(emit, t_c, frames[b_idx, pos])
        out, new_states = _pred_step(params["pred"], cfg, pick, states)
        states = _select(emit, new_states, states)
        pred_p = _select(emit, dense(joint["pred_proj"], out), pred_p)
        t = t + (~emit & ~done).long()
        n = n + emit.long()
        emit_n = torch.where(emit, emit_n + 1, 0)
        done = done | (t >= t_lens) | (n >= cap)
    outs = (tokens.int(),)
    if return_frames:
        outs += (frames.int(),)
    if return_state:
        outs += ((states, pred_p),)
    return outs[0] if len(outs) == 1 else outs


@torch.no_grad()
def greedy_decode(params: dict, cfg: Seq2SeqConfig, feats: torch.Tensor,
                  feat_lens: torch.Tensor, *, compute_dtype=None,
                  max_symbols_per_frame: int = 4) -> torch.Tensor:
    """End-to-end greedy decode: features -> token ids [B, max_output]."""
    _check_dtype(compute_dtype)
    attn_states, _, enc_lens = seq2seq.encode(params, cfg, feats, feat_lens)
    depth = cfg.num_layers["char"]
    return greedy_decode_states(
        params, cfg, attn_states[depth], enc_lens[depth],
        max_symbols_per_frame=max_symbols_per_frame)
