"""Pyramidal BiLSTM encoder (port of the RNN branch of
e2e_asr_tpu/models/encoder.py).

A stack of bidirectional LSTM layers; between layers, `skip_step`
consecutive frames are concatenated (halving the time resolution) until the
total reduction reaches `max_scaling_down`. Lengths follow ceil division.
In training each layer's output takes dropout with keep probability
`out_prob`, one keep-mask [T_d, B, 2H] per layer.
"""
from __future__ import annotations

import torch

from e2e_asr_tpu_torch.config import EncoderConfig
from e2e_asr_tpu_torch.core import cells, rnn
from e2e_asr_tpu_torch.core.layers import dropout_mask, uniform_init


def _enc_init(gen, shape, *, device=None):
    """Reference encoder kernels: U(-0.075, 0.075)."""
    return uniform_init(gen, shape, 0.075, device=device)


def _check_supported(cfg: EncoderConfig) -> None:
    if cfg.encoder_type != "rnn":
        raise NotImplementedError("the transformer encoder is not ported yet "
                                  "(ROADMAP.md Queue 1, 'Transformer family')")
    if not cfg.use_lstm:
        raise NotImplementedError("GRU encoders are not ported yet "
                                  "(ROADMAP.md Queue 1, 'GRU option')")
    if not cfg.bi_dir:
        raise NotImplementedError(
            "forward-only encoders are not ported yet (ROADMAP.md Queue 1, "
            "'Frontend')")


def layer_plan(cfg: EncoderConfig, max_depth: int) -> list[bool]:
    """For layer i (0-indexed), whether a pyramid reduction follows it."""
    plan = []
    fac = cfg.initial_res_fac
    for i in range(max_depth):
        reduce = (cfg.skip_step > 1 and i != max_depth - 1
                  and fac < cfg.max_scaling_down)
        plan.append(reduce)
        if reduce:
            fac *= cfg.skip_step
    return plan


def layer_input_dims(cfg: EncoderConfig, max_depth: int,
                     feat_dim: int) -> list[int]:
    """Input feature dim of each layer given the pyramid plan."""
    out_mult = 2 if cfg.bi_dir else 1
    dims = [feat_dim * cfg.stack_cons]
    plan = layer_plan(cfg, max_depth)
    for i in range(1, max_depth):
        out = cfg.hidden_size * out_mult
        dims.append(out * (cfg.skip_step if plan[i - 1] else 1))
    return dims


def init(gen: torch.Generator, cfg: EncoderConfig, max_depth: int,
         feat_dim: int, *, device=None) -> dict:
    _check_supported(cfg)
    dims = layer_input_dims(cfg, max_depth, feat_dim)
    return {f"layer_{i + 1}": {
        d: cells.lstm_init(gen, dims[i], cfg.hidden_size, init=_enc_init,
                           device=device) for d in ("fw", "bw")}
        for i in range(max_depth)}


def pyramid_reduce(x: torch.Tensor, lens: torch.Tensor, skip_step: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Concat skip_step consecutive frames: [B, T, F] -> [B, ceil(T/s), F*s];
    zero-pads T to a multiple of skip_step and ceil-divides the lengths."""
    B, T, F = x.shape
    rem = T % skip_step
    if rem:
        x = torch.nn.functional.pad(x, (0, 0, 0, skip_step - rem))
    x = x.reshape(B, x.shape[1] // skip_step, F * skip_step)
    lens = -torch.div(-lens.long(), skip_step, rounding_mode="floor")
    return x, lens


def apply(params: dict, cfg: EncoderConfig, x: torch.Tensor,
          seq_len: torch.Tensor, num_layers: dict[str, int], *,
          train: bool = False, compute_dtype=None, gen=None,
          drop_masks: dict | None = None):
    """Run the encoder.

    x: [B, T, F] batch-major features; seq_len: [B] true frame counts;
    num_layers: task -> encoder depth whose output that task attends to.
    train: output dropout on every layer, keep-masks from drop_masks
    {depth: bool [T_d, B, 2H]} where given, else drawn from `gen` (the
    reference draws layer d's from fold_in(rng, d)).
    Returns (attention_states {depth: [B, T_d, H_out]},
             time_major_states {depth: [T_d, B, H_out]},
             seq_lens {depth: [B]}).
    """
    _check_supported(cfg)
    if train and cfg.remat:
        raise NotImplementedError("remat is not ported yet (ROADMAP.md "
                                  "Queue 1, 'Training extensions')")
    drop = train and cfg.out_prob < 1.0
    max_depth = max(num_layers.values())
    want_attn = {d for t, d in num_layers.items() if t != "state"}
    want_time_major = {d for t, d in num_layers.items() if t == "state"}
    plan = layer_plan(cfg, max_depth)
    seq_len = seq_len.to(x.device).long()
    if cfg.initial_res_fac > 1:
        x = x[:, ::cfg.initial_res_fac, :]
        seq_len = -torch.div(-seq_len, cfg.initial_res_fac,
                             rounding_mode="floor")

    attention_states, time_major_states, seq_lens = {}, {}, {}
    layer_in = x
    for i in range(max_depth):
        depth = i + 1
        x_tm = layer_in.transpose(0, 1)
        out_dropout = None
        if drop:
            mask = (drop_masks or {}).get(depth)
            if mask is None:
                mask = dropout_mask(gen, (x_tm.shape[0], x_tm.shape[1],
                                          2 * cfg.hidden_size),
                                    cfg.out_prob, x.device)
            out_dropout = (cfg.out_prob, mask.to(x.device))
        out_tm = rnn.rnn_layer(params[f"layer_{depth}"], x_tm, seq_len,
                               compute_dtype=compute_dtype,
                               out_dropout=out_dropout)
        if depth in want_time_major:
            time_major_states[depth] = out_tm
        out_bm = out_tm.transpose(0, 1)
        if depth in want_attn:
            attention_states[depth] = out_bm
        seq_lens[depth] = seq_len
        if plan[i]:
            layer_in, seq_len = pyramid_reduce(out_bm, seq_len, cfg.skip_step)
        else:
            layer_in = out_bm
    return attention_states, time_major_states, seq_lens
