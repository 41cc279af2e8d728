"""Kernel #10: the GRU attention decoder's whole training pass, forward and
backward, one cooperative launch each (`csrc/dec_train_gru.cu`).

Replaces e2e_asr_tpu/ops/dec_train_gru_pallas.py `apply_train_fused`
(:675): the forward kernel `_fwd_call` (teacher forcing with scheduled
sampling from pre-shifted gumbel noise, dropout masks handed in) and the
backward kernel `_bwd_call`, with the weights in the order of
`_weight_args` (:221).

Bound on the H100: latency, as kernels #8/#9 (kernels/dec_train.py): a
step is a chain of about ten dependent products over B rows and about 4
MiB of f32 weights; at B = 128 none of them fills the card and the 47 steps
are serial. The same design: one persistent cooperative launch per
direction, grid barriers between the dependent stages of a step, 8 x 32
tiles (csrc/tiles.cuh); the attention, sampling and weight-gradient tiles
are shared with #8/#9 (csrc/dec_train.cuh). The GRU's carry is h alone
and the attention query is the top cell's h, so the attention gradient
enters h. The forward saves every intermediate (r | u, r*h, c, the
candidate's input contribution), and the backward recomputes nothing.

The products the reference leaves to XLA stay outside, in PyTorch, so
autograd carries their gradients on: tgx | tcx = emb_in @ W_lm_x + b,
EWb = embedding @ W_lm_x + b and hf = enc @ attn_w.

Envelope: one decoder layer, no SimpleProjection (the GRU family's
decoder at the flagship widths). Anything else raises NotImplementedError
on the card; the CPU runs the plain scan in models/attn_decoder.py.
"""
from __future__ import annotations

import torch

from e2e_asr_tpu_torch.core.cells import gru_split_step
from e2e_asr_tpu_torch.kernels import build

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
NEG_INF = -1e30

# The weights of `weight_args`, in the order of the reference's
# _weight_args: 13 fixed entries, then the decoder layer's 6.
W_NAMES = ("ewbg", "ewbc", "wghlm", "wchlm", "ipw", "ipb", "qw", "qb", "v",
           "apw", "apb", "opw", "opb", "wgx", "bg", "wgh", "wcx", "bc",
           "wch")


def check_supported(params: dict) -> None:
    """GRU decoder params of one layer without SimpleProjection."""
    if len(params["dec_cells"]) != 1 or "simple_proj" in params:
        raise NotImplementedError(
            "the fused GRU training decoder takes one decoder layer and no "
            "SimpleProjection (ROADMAP.md Queue 2, 'dec_train: deeper "
            "decoders')")


def weight_args(params: dict, emb_size: int) -> tuple:
    """The decoder weights in the kernel's order (W_NAMES). ewbg | ewbc is
    the embedding through the LM cell's input kernels with their biases
    folded in; ind_softmax swaps in the decoder's own output projection."""
    lm = params["lm_cell"]
    op = params["output_proj_ind" if "output_proj_ind" in params
                else "output_proj"]
    emb = params["embedding"]
    dec = params["dec_cells"][0]
    M = dec["candidate"]["kernel"].shape[0] - dec["candidate"]["bias"].shape[0]
    return (emb @ lm["gates"]["kernel"][:emb_size] + lm["gates"]["bias"],
            emb @ lm["candidate"]["kernel"][:emb_size]
            + lm["candidate"]["bias"],
            lm["gates"]["kernel"][emb_size:],
            lm["candidate"]["kernel"][emb_size:],
            params["input_proj"]["kernel"], params["input_proj"]["bias"],
            params["attn_query"]["kernel"], params["attn_query"]["bias"],
            params["attn_v"], params["attn_proj"]["kernel"],
            params["attn_proj"]["bias"], op["kernel"], op["bias"],
            dec["gates"]["kernel"][:M], dec["gates"]["bias"],
            dec["gates"]["kernel"][M:], dec["candidate"]["kernel"][:M],
            dec["candidate"]["bias"], dec["candidate"]["kernel"][M:])


def dec_train_gru_reference(weights, hf, enc, amask, tgx, tcx, gum_sh,
                            flag_sh, lm_masks, sampled=None):
    """Plain PyTorch version of the forward kernel (its backward is
    autograd's). weights: `weight_args`; hf [B,T,A]; enc [B,T,E]; amask
    [B,T]; tgx [S,B,2G], tcx [S,B,G]; gum_sh [S,B,V] and flag_sh [S,B] (row
    t holds step t-1's noise and coin, row 0 zero) or None; lm_masks
    [S,B,G] or None. sampled [S,B]: replay these sampled tokens instead of
    taking the argmax (to hold a kernel's run to this one past a
    near-tie). Returns logits [S,B,V]."""
    (ewbg, ewbc, wghlm, wchlm, ipw, ipb, qw, qb, v, apw, apb, opw, opb, wgx,
     bg, wgh, wcx, bc, wch) = weights
    S, B, G = tcx.shape
    D = wch.shape[0]
    zeros = tcx.new_zeros
    h_lm, h = zeros(B, G), zeros(B, D)
    ctx = zeros(B, enc.shape[-1])
    logits = zeros(B, opb.shape[0])
    out = []
    for t in range(S):
        gx, cx = tgx[t], tcx[t]
        if gum_sh is not None and t > 0:
            idx = (torch.argmax(logits.detach() + gum_sh[t], dim=-1)
                   if sampled is None else sampled[t])
            flag = flag_sh[t][:, None]
            gx = flag * ewbg[idx] + (1.0 - flag) * gx
            cx = flag * ewbc[idx] + (1.0 - flag) * cx
        h_lm = gru_split_step(gx, cx, h_lm, wghlm, wchlm)
        lm_out = h_lm * lm_masks[t] if lm_masks is not None else h_lm
        x_dec = lm_out @ ipw[:G] + ctx @ ipw[G:] + ipb
        h = gru_split_step(x_dec @ wgx + bg, x_dec @ wcx + bc, h, wgh, wch)
        y = h @ qw + qb
        s = torch.sum(v * torch.tanh(hf + y[:, None, :]), dim=-1)
        s = torch.where(amask > 0, s, torch.full_like(s, NEG_INF))
        alpha = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bt,bte->be", alpha, enc)
        logits = (h @ apw[:D] + ctx @ apw[D:] + apb) @ opw + opb
        out.append(logits)
    return torch.stack(out)


def _dims(weights, enc, tcx):
    S, B, G = tcx.shape
    wgx, wch = weights[13], weights[18]
    return (S, B, G, wch.shape[0], wgx.shape[0], enc.shape[-1],
            weights[6].shape[1], weights[0].shape[0], enc.shape[1])


def _check(weights, hf, enc, amask, tgx, tcx, gum_sh, flag_sh, lm_masks,
           dims):
    S, B, G, D, M, E, A, V, T = dims
    dev = tcx.device
    shapes = ((V, 2 * G), (V, G), (G, 2 * G), (G, G), (G + E, M), (M,),
              (D, A), (A,), (A,), (D + E, D), (D,), (D, V), (V,), (M, 2 * D),
              (2 * D,), (D, 2 * D), (M, D), (D,), (D, D))
    f32, req = torch.float32, build.require
    for name, w, shape in zip(W_NAMES, weights, shapes):
        req(w, name, f32, shape, dev)
    req(hf, "hf", f32, (B, T, A), dev)
    req(enc, "enc", f32, (B, T, E), dev)
    req(amask, "amask", f32, (B, T), dev)
    req(tgx, "tgx", f32, (S, B, 2 * G), dev)
    req(tcx, "tcx", f32, (S, B, G), dev)
    if (gum_sh is None) != (flag_sh is None):
        raise ValueError("gum_sh and flag_sh go together")
    if gum_sh is not None:
        req(gum_sh, "gum_sh", f32, (S, B, V), dev)
        req(flag_sh, "flag_sh", f32, (S, B), dev)
    if lm_masks is not None:
        req(lm_masks, "lm_masks", f32, (S, B, G), dev)


# The forward's saves the backward reads, in the C entry's order.
_SAVES = ("ru_lm", "rh_lm", "c_lm", "hlm", "lm_out", "x_dec", "ru_dec",
          "rh_dec", "c_dec", "hdec", "y", "alpha", "ctx", "proj", "oh")


class _DecTrainGRU(torch.autograd.Function):
    """Forward and backward of kernel #10 (the forward saves every
    intermediate)."""

    @staticmethod
    def forward(ctx, hf, enc, amask, tgx, tcx, gum_sh, flag_sh, lm_masks,
                *weights):
        global FWD_LAUNCHES
        dims = _dims(weights, enc, tcx)
        _check(weights, hf, enc, amask, tgx, tcx, gum_sh, flag_sh, lm_masks,
               dims)
        S, B, G, D, M, E, A, V, T = dims
        dev = tcx.device
        zeros = torch.zeros(B * max(G, D, E), device=dev)
        # W_gx over W_gh: the decoder gates of [x_dec | h] in one product.
        wg = torch.cat([weights[13], weights[15]])
        kernel_w = (*weights[:13], wg, *weights[14:15], *weights[16:])
        widths = dict(logits=V, ru_lm=2 * G, rh_lm=G, cx_lm=G, c_lm=G,
                      hlm=G, lm_out=G, x_dec=M, ru_dec=2 * D, rh_dec=D,
                      cx_dec=D, c_dec=D, hdec=D, y=A, alpha=T, ctx=E, proj=D)
        saves = {k: torch.empty(S, B, w, device=dev)
                 for k, w in widths.items()}
        saves["oh"] = (torch.zeros(S, B, V, device=dev)
                       if gum_sh is not None else None)
        ptr_list = [*kernel_w, hf, enc, amask, tgx, tcx, gum_sh, flag_sh,
                    lm_masks, zeros, *saves.values()]
        lib = build.library()
        with torch.cuda.device(dev):
            err = lib.e2e_dec_train_gru_fwd(
                build.ptrs(*ptr_list), len(ptr_list), build.ints(*dims),
                build.stream_ptr(dev))
        build.check(err, "dec_train_gru_fwd")
        FWD_LAUNCHES += 1
        ctx.dims = dims
        ctx.save_for_backward(hf, enc, flag_sh, lm_masks, zeros, *weights,
                              *[saves[k] for k in _SAVES])
        return saves["logits"]

    @staticmethod
    def backward(ctx, dlogits):
        global BWD_LAUNCHES
        S, B, G, D, M, E, A, V, T = dims = ctx.dims
        hf, enc, flag_sh, lm_masks, zeros, *rest = ctx.saved_tensors
        weights, saves = rest[:19], rest[19:]
        (_, _, wghlm, wchlm, ipw, _, qw, _, v, apw, _, opw, _, wgx, _, wgh,
         wcx, _, wch) = weights
        dev = hf.device
        transposed = [w.t().contiguous() for w in (
            opw, apw, qw, wch, torch.cat([wgx, wcx], dim=1), wgh, ipw,
            wchlm, wghlm)]
        new = lambda *shape: torch.empty(*shape, device=dev)  # noqa: E731
        steps = [new(S, B, w) for w in (D, A, 2 * D, D, M, 2 * G, G)]
        outs = [new(S, B, 2 * G), new(S, B, G), new(B, T, A), new(B, T, E)]
        wshapes = [w.shape for w in weights[:13]] + [
            (M + D, 2 * D), (2 * D,), (M, D), (D,), (D, D)]
        dweights = [new(*s) for s in wshapes]
        scratch = [new(B, w) for w in (D + E, A, D, D, G, G, E)]
        ptr_list = [*transposed, v, hf, enc, flag_sh, lm_masks, zeros,
                    *saves, dlogits.contiguous(), *steps, *outs, *dweights,
                    *scratch]
        lib = build.library()
        with torch.cuda.device(dev):
            err = lib.e2e_dec_train_gru_bwd(
                build.ptrs(*ptr_list), len(ptr_list), build.ints(*dims),
                build.stream_ptr(dev))
        build.check(err, "dec_train_gru_bwd")
        BWD_LAUNCHES += 1
        dtgx, dtcx, dhf, denc = outs
        dwg = dweights[13]
        grads = (*dweights[:13], dwg[:M], dweights[14], dwg[M:],
                 *dweights[15:])
        return (dhf, denc, None, dtgx, dtcx, None, None, None, *grads)


def dec_train_gru(weights, hf, enc, amask, tgx, tcx, gum_sh=None,
                  flag_sh=None, lm_masks=None):
    """Logits [S,B,V] of the whole training pass (arguments as
    `dec_train_gru_reference`); differentiable on both devices."""
    if tcx.device.type == "cpu":
        return dec_train_gru_reference(weights, hf, enc, amask, tgx, tcx,
                                       gum_sh, flag_sh, lm_masks)
    if tcx.device.type != "cuda":
        raise ValueError(f"dec_train_gru: unsupported device {tcx.device}")
    return _DecTrainGRU.apply(hf, enc, amask, tgx, tcx, gum_sh, flag_sh,
                              lm_masks, *weights)


def apply_train_fused(params: dict, cfg, emb_inputs, enc_states, enc_lens,
                      flags, gumbel, lm_masks):
    """The fused form of attn_decoder.apply_train for GRU decoders (same
    noise, same function): emb_inputs [T,B,emb] -> logits [T-1,B,V].

    flags [T-1] 0/1 sampling coins and gumbel [T-1,B,V] (None without
    scheduled sampling); lm_masks [T-1,B,G] float dropout masks or None."""
    check_supported(params)
    T, B, emb_size = emb_inputs.shape
    steps = T - 1
    lm = params["lm_cell"]
    x = emb_inputs[:steps]
    tgx = x @ lm["gates"]["kernel"][:emb_size] + lm["gates"]["bias"]
    tcx = x @ lm["candidate"]["kernel"][:emb_size] + lm["candidate"]["bias"]
    weights = weight_args(params, emb_size)
    hf = enc_states @ params["attn_w"]
    T_enc = enc_states.shape[1]
    amask = (torch.arange(T_enc, device=enc_states.device)[None, :]
             < enc_lens.to(enc_states.device).long()[:, None]).float()
    gum_sh = flag_sh = None
    if gumbel is not None:
        # Step t reads step t-1's logits and noise; row 0 is teacher-forced.
        V = gumbel.shape[-1]
        gum_sh = torch.cat([gumbel.new_zeros(1, B, V), gumbel[:-1]])
        flag_sh = torch.cat([flags.new_zeros(1), flags[:-1]])[:, None].expand(
            steps, B).contiguous()
    if lm_masks is not None:
        lm_masks = lm_masks.expand(steps, B, -1).contiguous()
    return dec_train_gru([w.contiguous() for w in weights], hf.contiguous(),
                         enc_states.contiguous(), amask, tgx.contiguous(),
                         tcx.contiguous(), gum_sh, flag_sh, lm_masks)
