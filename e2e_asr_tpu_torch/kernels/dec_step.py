"""Kernels B and C: one attention-decoder inference step
(`csrc/dec_step.cu`), split around the additive attention, which stays in
plain PyTorch as the reference leaves it to XLA (kernels/beam_mega.py
`search`, the per-step route of eval/beam.py) unless kernel #13
(kernels/attn_output.py) folds it into C.

B `cells_fused` replaces e2e_asr_tpu/ops/dec_step_pallas.py `cells_fused`,
both its branches: decoder-LM cell -> [SimpleProjection] ->
InputProjection([lm_out, ctx_prev]) -> L decoder cells -> attention query
y = q @ W_q + b_q, q the top cell's c for LSTM cells and its h for GRU
cells (TF-1 GRUCell: r|u = sigmoid([x | h] @ W_g + b_g), c = tanh([x | r*h]
@ W_c + b_c), h' = u*h + (1-u)*c; no constant added to any gate).
C `output_fused` replaces dec_step_pallas.py `output_fused`:
AttnProjection([query, context]) -> OutputProjection -> log_softmax.

Bound on the H100: neither FLOPs nor bandwidth but latency. At the serving
shape (N = 8 batch rows x 4 beams = 32 rows) B is a chain of four dependent
products over about 5 MiB of f32 weights (1.3 MFLOP per row), C two more
over 1 MiB; each product alone is far too small to fill the card, and the
plain version pays one launch per operation (about ten for B, five for C).

Design: B is ONE cooperative launch, at most one block per output tile and
no more than the card holds at once, with a grid-wide barrier between the
dependent stages; each block owns 8 rows x 32 output units of a stage, so
the weights are spread over the SMs and every weight column is read once
per 8 rows. A GRU cell takes two stages where an LSTM cell takes one: its
candidate's recurrent product needs all of r*h, so a grid barrier sits
between the gates and the candidate (csrc/tiles.cuh `cell_stages`). C uses
the same machinery: one cooperative launch whose stages, separated by grid
barriers, write AttnProjection into a global scratch buffer [N, H], then
the logits into logp [N, V], then take the log_softmax in place in global
memory, one warp per row. Tensor cores (wgmma) and keeping the weights
resident in shared memory across steps are later work.

Float32 only: bf16 matmuls raise NotImplementedError (ROADMAP.md Queue 1,
"Decode features").
"""
from __future__ import annotations

import torch

from e2e_asr_tpu_torch.core.cells import LSTMState, gru_step, lstm_step
from e2e_asr_tpu_torch.core.layers import dense
from e2e_asr_tpu_torch.kernels import build

CELLS_LAUNCHES = 0        # B with LSTM cells
CELLS_GRU_LAUNCHES = 0    # B with GRU cells
OUTPUT_LAUNCHES = 0


def check_bf16(bf16: bool) -> None:
    if bf16:
        raise NotImplementedError("bf16 decode matmuls are not ported yet "
                                  "(ROADMAP.md Queue 1, 'Decode features')")


def out_proj(params: dict, cfg) -> dict:
    return params["output_proj_ind" if cfg.ind_softmax else "output_proj"]


def cells_fused_reference(params: dict, x_emb, ctx_prev, lm_state,
                          dec_states: tuple, *, use_lstm: bool = True):
    """Plain PyTorch version of B: (new_lm_state, new_dec_states, y). A
    state is an LSTMState for LSTM cells and the bare h [N, H] for GRU
    cells."""
    step = lstm_step if use_lstm else gru_step
    lm_out, new_lm = step(params["lm_cell"], x_emb, lm_state)
    if "simple_proj" in params:
        lm_out = dense(params["simple_proj"], lm_out)
    x = dense(params["input_proj"], torch.cat([lm_out, ctx_prev], dim=-1))
    new_dec = []
    for cp, state in zip(params["dec_cells"], dec_states):
        x, new_s = step(cp, x, state)
        new_dec.append(new_s)
    y = dense(params["attn_query"], new_dec[-1].c if use_lstm else x)
    return new_lm, tuple(new_dec), y


def cells_fused(params: dict, x_emb, ctx_prev, lm_state, dec_states, *,
                use_lstm: bool = True, bf16: bool = False):
    """Decoder-LM + [SimpleProjection] + InputProjection + stacked decoder
    cells + query projection for one step. All arrays [N, .] float32.

    dec_states: tuple of per-layer states, LSTMState for LSTM cells and h
    [N, H] for GRU cells (a single state is accepted and then returned
    single, as in the reference). Returns (new_lm_state, new_dec_states,
    query_y [N, A]).
    """
    check_bf16(bf16)
    single = isinstance(dec_states, LSTMState) or (
        not use_lstm and not isinstance(dec_states, (tuple, list)))
    if single:
        dec_states = (dec_states,)
    if len(dec_states) != len(params["dec_cells"]):
        raise ValueError(f"{len(dec_states)} decoder states for "
                         f"{len(params['dec_cells'])} decoder cells")
    if x_emb.device.type == "cpu":
        new_lm, new_dec, y = cells_fused_reference(
            params, x_emb, ctx_prev, lm_state, dec_states, use_lstm=use_lstm)
    elif x_emb.device.type == "cuda":
        new_lm, new_dec, y = _cells_fused_cuda(params, x_emb, ctx_prev,
                                               lm_state, dec_states, use_lstm)
    else:
        raise ValueError(f"cells_fused: unsupported device {x_emb.device}")
    return new_lm, (new_dec[0] if single else new_dec), y


def _cell_ptrs(name: str, cp: dict, state, in_dim: int, hidden: int,
               use_lstm: bool, c_out, h_out, dev) -> list:
    """A cell's 8 pointers for csrc/dec_step.cu (c, h, w, b, wc, bc, c_out,
    h_out), its arrays checked."""
    f32, req = torch.float32, build.require
    N = h_out.shape[0]
    if use_lstm:
        req(cp["kernel"], f"{name}/kernel", f32, (in_dim + hidden, 4 * hidden),
            dev)
        req(cp["bias"], f"{name}/bias", f32, (4 * hidden,), dev)
        req(state.c, f"{name} state c", f32, (N, hidden), dev)
        req(state.h, f"{name} state h", f32, (N, hidden), dev)
        return [state.c, state.h, cp["kernel"], cp["bias"], None, None, c_out,
                h_out]
    g, c = cp["gates"], cp["candidate"]
    req(g["kernel"], f"{name}/gates/kernel", f32,
        (in_dim + hidden, 2 * hidden), dev)
    req(g["bias"], f"{name}/gates/bias", f32, (2 * hidden,), dev)
    req(c["kernel"], f"{name}/candidate/kernel", f32,
        (in_dim + hidden, hidden), dev)
    req(c["bias"], f"{name}/candidate/bias", f32, (hidden,), dev)
    req(state, f"{name} state h", f32, (N, hidden), dev)
    return [None, state, g["kernel"], g["bias"], c["kernel"], c["bias"], None,
            h_out]


def _cells_fused_cuda(params, x_emb, ctx_prev, lm_state, dec_states,
                      use_lstm):
    global CELLS_LAUNCHES, CELLS_GRU_LAUNCHES
    dev = x_emb.device
    N, E = x_emb.shape
    Henc = ctx_prev.shape[-1]
    Hl = (lm_state.h if use_lstm else lm_state).shape[-1]
    H = (dec_states[0].h if use_lstm else dec_states[0]).shape[-1]
    A = params["attn_query"]["kernel"].shape[-1]
    L = len(dec_states)
    sp = params.get("simple_proj")
    if sp is None and Hl != H:
        raise ValueError(f"lm_hidden {Hl} != hidden {H} needs simple_proj")
    f32 = torch.float32
    req = build.require
    req(x_emb, "x_emb", f32, (N, E), dev)
    req(ctx_prev, "ctx_prev", f32, (N, Henc), dev)
    if sp is not None:
        req(sp["kernel"], "simple_proj/kernel", f32, (Hl, H), dev)
        req(sp["bias"], "simple_proj/bias", f32, (H,), dev)
    ip = params["input_proj"]
    req(ip["kernel"], "input_proj/kernel", f32, (H + Henc, E), dev)
    req(ip["bias"], "input_proj/bias", f32, (E,), dev)
    q = params["attn_query"]
    req(q["kernel"], "attn_query/kernel", f32, (H, A), dev)
    req(q["bias"], "attn_query/bias", f32, (A,), dev)

    # Every output and the scratch buffers in one allocation: an LSTM cell
    # writes c and h, a GRU cell h and uses r*h and u (width max(Hl, H)).
    ns = 2 if use_lstm else 1
    Hg = 0 if use_lstm else max(Hl, H)
    widths = ([Hl] * ns + [H if sp is not None else 0, E, A, Hg, Hg]
              + [H] * (ns * L))
    flat = torch.empty(N * sum(widths), device=dev)
    parts = [part.view(N, w) for part, w in
             zip(flat.split([N * w for w in widths]), widths)]
    lm_out, (sp_out, x_out, y, rh, ug), dec = (parts[:ns], parts[ns:ns + 5],
                                               parts[ns + 5:])
    ptr_list = [x_emb, ctx_prev, None if sp is None else sp["kernel"],
                None if sp is None else sp["bias"], ip["kernel"], ip["bias"],
                q["kernel"], q["bias"], None if sp is None else sp_out, x_out,
                y, None if use_lstm else rh, None if use_lstm else ug]
    ptr_list += _cell_ptrs("lm_cell", params["lm_cell"], lm_state, E, Hl,
                           use_lstm, lm_out[0] if use_lstm else None,
                           lm_out[-1], dev)
    for layer, (cp, s) in enumerate(zip(params["dec_cells"], dec_states)):
        ptr_list += _cell_ptrs(f"dec_cells/{layer}", cp, s,
                               E if layer == 0 else H, H, use_lstm,
                               dec[ns * layer] if use_lstm else None,
                               dec[ns * layer + ns - 1], dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.e2e_cells_fused(build.ptrs(*ptr_list), len(ptr_list),
                                  build.ints(N, E, Henc, Hl, H, A, L,
                                             int(not use_lstm)), 8,
                                  build.stream_ptr(dev))
    build.check(err, "cells_fused")
    if use_lstm:
        CELLS_LAUNCHES += 1
        return (LSTMState(*lm_out),
                tuple(LSTMState(dec[2 * i], dec[2 * i + 1])
                      for i in range(L)),
                y)
    CELLS_GRU_LAUNCHES += 1
    return lm_out[0], tuple(dec), y


def output_fused_reference(params: dict, cfg, query, context):
    """Plain PyTorch version of C: log-probs [N, V]."""
    proj = dense(params["attn_proj"], torch.cat([query, context], dim=-1))
    return torch.log_softmax(dense(out_proj(params, cfg), proj), dim=-1)


def output_fused(params: dict, cfg, query, context, *,
                 bf16: bool = False):
    """AttnProjection + OutputProjection + log_softmax. query [N, H],
    context [N, H_enc] -> log-probs [N, V] float32."""
    global OUTPUT_LAUNCHES
    check_bf16(bf16)
    if query.device.type == "cpu":
        return output_fused_reference(params, cfg, query, context)
    if query.device.type != "cuda":
        raise ValueError(f"output_fused: unsupported device {query.device}")
    dev = query.device
    N, H = query.shape
    Henc = context.shape[-1]
    out = out_proj(params, cfg)
    V = out["kernel"].shape[-1]
    f32 = torch.float32
    req = build.require
    req(query, "query", f32, (N, H), dev)
    req(context, "context", f32, (N, Henc), dev)
    ap = params["attn_proj"]
    req(ap["kernel"], "attn_proj/kernel", f32, (H + Henc, H), dev)
    req(ap["bias"], "attn_proj/bias", f32, (H,), dev)
    req(out["kernel"], "output_proj/kernel", f32, (H, V), dev)
    req(out["bias"], "output_proj/bias", f32, (V,), dev)
    flat = torch.empty(N * (V + H), device=dev)
    logp, proj = flat[:N * V].view(N, V), flat[N * V:]   # proj: scratch
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.e2e_output_fused(
            query.data_ptr(), context.data_ptr(), ap["kernel"].data_ptr(),
            ap["bias"].data_ptr(), out["kernel"].data_ptr(),
            out["bias"].data_ptr(), proj.data_ptr(), logp.data_ptr(), N, H,
            Henc, V, build.stream_ptr(dev))
    build.check(err, "output_fused")
    OUTPUT_LAUNCHES += 1
    return logp
