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

Envelope: the reference's GRU decoder space: 1 to 8 stacked decoder cells
(`dec_train.MAX_LAYERS`) with their inter-layer dropout masks,
SimpleProjection when lm_hidden != hidden, and ind_softmax. A deeper stack
raises ValueError naming its depth on the card; the CPU runs the plain
scan in models/attn_decoder.py.
"""
from __future__ import annotations

import torch

from e2e_asr_tpu_torch.core.cells import gru_split_step
from e2e_asr_tpu_torch.kernels import build, dec_train

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
DEPTHS = {}          # decoder layers -> forward launches at that depth
NEG_INF = -1e30

# The weights of `weight_args`, in the order of the reference's
# _weight_args: 13 fixed entries, then each decoder layer's 6 (LAYER_NAMES),
# then SimpleProjection's kernel and bias where the decoder has it.
W_NAMES = ("ewbg", "ewbc", "wghlm", "wchlm", "ipw", "ipb", "qw", "qb", "v",
           "apw", "apb", "opw", "opb")
LAYER_NAMES = ("wgx", "bg", "wgh", "wcx", "bc", "wch")


def weight_args(params: dict, emb_size: int) -> tuple:
    """The decoder weights in the kernel's order (W_NAMES, LAYER_NAMES per
    layer, SimpleProjection). ewbg | ewbc is the embedding through the LM
    cell's input kernels with their biases folded in; ind_softmax swaps in
    the decoder's own output projection."""
    lm = params["lm_cell"]
    op = params["output_proj_ind" if "output_proj_ind" in params
                else "output_proj"]
    emb = params["embedding"]
    out = [emb @ lm["gates"]["kernel"][:emb_size] + lm["gates"]["bias"],
           emb @ lm["candidate"]["kernel"][:emb_size]
           + lm["candidate"]["bias"],
           lm["gates"]["kernel"][emb_size:],
           lm["candidate"]["kernel"][emb_size:],
           params["input_proj"]["kernel"], params["input_proj"]["bias"],
           params["attn_query"]["kernel"], params["attn_query"]["bias"],
           params["attn_v"], params["attn_proj"]["kernel"],
           params["attn_proj"]["bias"], op["kernel"], op["bias"]]
    for dec in params["dec_cells"]:
        cand = dec["candidate"]
        K = cand["kernel"].shape[0] - cand["bias"].shape[0]
        out += [dec["gates"]["kernel"][:K], dec["gates"]["bias"],
                dec["gates"]["kernel"][K:], dec["candidate"]["kernel"][:K],
                dec["candidate"]["bias"], dec["candidate"]["kernel"][K:]]
    if "simple_proj" in params:
        out += [params["simple_proj"]["kernel"], params["simple_proj"]["bias"]]
    return tuple(out)


def _split(weights, sp: bool):
    """(the 13 fixed weights, [the 6 of each decoder layer], (spw, spb) or
    None)."""
    rest = weights[13:len(weights) - (2 if sp else 0)]
    layers = [tuple(rest[i:i + 6]) for i in range(0, len(rest), 6)]
    return weights[:13], layers, (tuple(weights[-2:]) if sp else None)


def dec_train_gru_reference(weights, hf, enc, amask, tgx, tcx, gum_sh,
                            flag_sh, lm_masks, inter_masks=None,
                            sampled=None, *, sp: bool = False):
    """Plain PyTorch version of the forward kernel (its backward is
    autograd's). weights: `weight_args`; sp: whether they end with
    SimpleProjection's; hf [B,T,A]; enc [B,T,E]; amask [B,T]; tgx [S,B,2G],
    tcx [S,B,G]; gum_sh [S,B,V] and flag_sh [S,B] (row t holds step t-1's
    noise and coin, row 0 zero) or None; lm_masks [S,B,G] or None;
    inter_masks [NL-1,S,B,D] or None. sampled [S,B]: replay these sampled
    tokens instead of taking the argmax (to hold a kernel's run to this one
    past a near-tie). Returns logits [S,B,V]."""
    fixed, layers, spp = _split(weights, sp)
    (ewbg, ewbc, wghlm, wchlm, ipw, ipb, qw, qb, v, apw, apb, opw,
     opb) = fixed
    S, B, G = tcx.shape
    D = layers[0][5].shape[0]
    HID = D if sp else G
    zeros = tcx.new_zeros
    h_lm = zeros(B, G)
    hs = [zeros(B, D) for _ in layers]
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
        if spp is not None:
            lm_out = lm_out @ spp[0] + spp[1]
        inp = lm_out @ ipw[:HID] + ctx @ ipw[HID:] + ipb
        for l, (wgx, bg, wgh, wcx, bc, wch) in enumerate(layers):
            hs[l] = gru_split_step(inp @ wgx + bg, inp @ wcx + bc, hs[l], wgh,
                                   wch)
            inp = hs[l]
            if inter_masks is not None and l < len(layers) - 1:
                inp = inp * inter_masks[l][t]
        h = hs[-1]
        y = h @ qw + qb
        s = torch.sum(v * torch.tanh(hf + y[:, None, :]), dim=-1)
        s = torch.where(amask > 0, s, torch.full_like(s, NEG_INF))
        alpha = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bt,bte->be", alpha, enc)
        logits = (h @ apw[:D] + ctx @ apw[D:] + apb) @ opw + opb
        out.append(logits)
    return torch.stack(out)


def _dims(weights, enc, tcx, sp: bool):
    S, B, G = tcx.shape
    _, layers, _ = _split(weights, sp)
    return (S, B, G, layers[0][5].shape[0], layers[0][0].shape[0],
            enc.shape[-1], weights[6].shape[1], weights[0].shape[0],
            enc.shape[1], len(layers))


def _check(weights, hf, enc, amask, tgx, tcx, gum_sh, flag_sh, lm_masks,
           inter_masks, dims, sp):
    S, B, G, D, M, E, A, V, T, NL = dims
    if not 1 <= NL <= dec_train.MAX_LAYERS:
        raise ValueError(f"dec_train_gru: {NL} decoder layers; the kernel "
                         f"takes 1 to {dec_train.MAX_LAYERS}")
    HID = D if sp else G
    dev = tcx.device
    shapes = [(V, 2 * G), (V, G), (G, 2 * G), (G, G), (HID + E, M), (M,),
              (D, A), (A,), (A,), (D + E, D), (D,), (D, V), (V,)]
    names = list(W_NAMES)
    for l in range(NL):
        K = M if l == 0 else D
        shapes += [(K, 2 * D), (2 * D,), (D, 2 * D), (K, D), (D,), (D, D)]
        names += [f"{n}{l}" for n in LAYER_NAMES]
    if sp:
        shapes += [(G, D), (D,)]
        names += ["spw", "spb"]
    if len(weights) != len(shapes):
        raise ValueError(f"dec_train_gru: {len(weights)} weights, expected "
                         f"{len(shapes)}")
    f32, req = torch.float32, build.require
    for name, w, shape in zip(names, weights, shapes):
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
    if inter_masks is not None:
        if NL == 1:
            raise ValueError("inter_masks need more than one decoder layer")
        req(inter_masks, "inter_masks", f32, (NL - 1, S, B, D), dev)


# The forward's saves the backward reads, in the C entry's order.
_SAVES = ("ru_lm", "rh_lm", "c_lm", "hlm", "lm_out", "x_dec", "ru_dec",
          "rh_dec", "c_dec", "hdec", "y", "alpha", "ctx", "proj", "oh")


def _kernel_layer(layer):
    """A layer's 6 weights as the forward kernel takes them: W_gx over W_gh
    (the gates of [in | h] in one product), b_g, W_cx, b_c, W_ch."""
    wgx, bg, wgh, wcx, bc, wch = layer
    return torch.cat([wgx, wgh]), bg, wcx, bc, wch


class _DecTrainGRU(torch.autograd.Function):
    """Forward and backward of kernel #10 (the forward saves every
    intermediate)."""

    @staticmethod
    def forward(ctx, sp, hf, enc, amask, tgx, tcx, gum_sh, flag_sh, lm_masks,
                inter_masks, *weights):
        global FWD_LAUNCHES
        dims = _dims(weights, enc, tcx, sp)
        _check(weights, hf, enc, amask, tgx, tcx, gum_sh, flag_sh, lm_masks,
               inter_masks, dims, sp)
        S, B, G, D, M, E, A, V, T, NL = dims
        dev = tcx.device
        zeros = torch.zeros(B * max(G, D, E), device=dev)
        fixed, layers, spp = _split(weights, sp)
        new = lambda *shape: torch.empty(*shape, device=dev)  # noqa: E731
        saves = {k: new(S, B, w) for k, w in dict(
            logits=V, ru_lm=2 * G, rh_lm=G, cx_lm=G, c_lm=G, hlm=G, lm_out=G,
            x_dec=M).items()}
        saves.update(ru_dec=new(NL, S, B, 2 * D))
        for k in ("rh_dec", "cx_dec", "c_dec", "hdec"):
            saves[k] = new(NL, S, B, D)
        for k, w in dict(y=A, alpha=T, ctx=E, proj=D).items():
            saves[k] = new(S, B, w)
        saves["oh"] = (torch.zeros(S, B, V, device=dev)
                       if gum_sh is not None else None)
        lm_sp = new(S, B, D) if sp else None
        hdrop = new(NL - 1, S, B, D) if NL > 1 else None
        kernel_layers = [_kernel_layer(layer) for layer in layers]
        ptr_list = [*fixed, *kernel_layers[0], hf, enc, amask, tgx, tcx,
                    gum_sh, flag_sh, lm_masks, zeros, *saves.values(),
                    *(spp or (None, None)), lm_sp, inter_masks, hdrop,
                    *[w for layer in kernel_layers[1:] for w in layer]]
        lib = build.library()
        with torch.cuda.device(dev):
            err = lib.e2e_dec_train_gru_fwd(
                build.ptrs(*ptr_list), len(ptr_list), build.ints(*dims),
                build.stream_ptr(dev))
        build.check(err, "dec_train_gru_fwd")
        FWD_LAUNCHES += 1
        DEPTHS[NL] = DEPTHS.get(NL, 0) + 1
        ctx.dims, ctx.sp = dims, sp
        ctx.save_for_backward(hf, enc, flag_sh, lm_masks, inter_masks, zeros,
                              lm_sp, hdrop, *weights,
                              *[saves[k] for k in _SAVES])
        return saves["logits"]

    @staticmethod
    def backward(ctx, dlogits):
        global BWD_LAUNCHES
        S, B, G, D, M, E, A, V, T, NL = dims = ctx.dims
        sp = ctx.sp
        (hf, enc, flag_sh, lm_masks, inter_masks, zeros, lm_sp, hdrop,
         *rest) = ctx.saved_tensors
        n_w = len(rest) - len(_SAVES)
        weights, saves = rest[:n_w], rest[n_w:]
        fixed, layers, spp = _split(weights, sp)
        (_, _, wghlm, wchlm, ipw, _, qw, _, v, apw, _, opw, _) = fixed
        dev = hf.device
        T_ = lambda w: w.t().contiguous()  # noqa: E731
        new = lambda *shape: torch.empty(*shape, device=dev)  # noqa: E731

        def transposed(layer):   # wchT, wxT = [W_gx | W_cx]^T, wghT
            wgx, _, wgh, wcx, _, wch = layer
            return T_(wch), T_(torch.cat([wgx, wcx], dim=1)), T_(wgh)

        def grads(layer):        # dwg (W_gx over W_gh), dbg, dwcx, dbc, dwch
            wgx, bg, wgh, wcx, bc, wch = layer
            return [new(wgx.shape[0] + D, 2 * D), new(*bg.shape),
                    new(*wcx.shape), new(*bc.shape), new(*wch.shape)]

        steps = [new(S, B, D), new(S, B, A), new(NL, S, B, 2 * D),
                 new(NL, S, B, D), new(S, B, M), new(S, B, 2 * G),
                 new(S, B, G)]
        outs = [new(S, B, 2 * G), new(S, B, G), new(B, T, A), new(B, T, E)]
        dfixed = [new(*w.shape) for w in fixed]
        dlayers = [grads(layer) for layer in layers]
        scratch = [new(B, D + E), new(B, A), new(NL, B, D), new(NL, B, D),
                   new(B, G), new(B, G), new(B, E)]
        dsp = new(S, B, D) if sp else None
        dspp = [new(*w.shape) for w in spp] if sp else [None, None]
        ptr_list = [T_(opw), T_(apw), T_(qw), *transposed(layers[0]),
                    T_(ipw), T_(wchlm), T_(wghlm), v, hf, enc, flag_sh,
                    lm_masks, zeros, *saves, dlogits.contiguous(), *steps,
                    *outs, *dfixed, *dlayers[0], *scratch,
                    T_(spp[0]) if sp else None, lm_sp, dsp, inter_masks,
                    hdrop, *dspp]
        for layer, dlayer in zip(layers[1:], dlayers[1:]):
            ptr_list += [*transposed(layer), *dlayer]
        lib = build.library()
        with torch.cuda.device(dev):
            err = lib.e2e_dec_train_gru_bwd(
                build.ptrs(*ptr_list), len(ptr_list), build.ints(*dims),
                build.stream_ptr(dev))
        build.check(err, "dec_train_gru_bwd")
        BWD_LAUNCHES += 1
        dtgx, dtcx, dhf, denc = outs
        dweights = list(dfixed)
        for layer, (dwg, dbg, dwcx, dbc, dwch) in zip(layers, dlayers):
            K = layer[0].shape[0]
            dweights += [dwg[:K], dbg, dwg[K:], dwcx, dbc, dwch]
        if sp:
            dweights += dspp
        return (None, dhf, denc, None, dtgx, dtcx, None, None, None, None,
                *dweights)


def dec_train_gru(weights, hf, enc, amask, tgx, tcx, gum_sh=None,
                  flag_sh=None, lm_masks=None, inter_masks=None, *,
                  sp: bool = False):
    """Logits [S,B,V] of the whole training pass (arguments as
    `dec_train_gru_reference`); differentiable on both devices."""
    if tcx.device.type == "cpu":
        return dec_train_gru_reference(weights, hf, enc, amask, tgx, tcx,
                                       gum_sh, flag_sh, lm_masks, inter_masks,
                                       sp=sp)
    if tcx.device.type != "cuda":
        raise ValueError(f"dec_train_gru: unsupported device {tcx.device}")
    return _DecTrainGRU.apply(sp, hf, enc, amask, tgx, tcx, gum_sh, flag_sh,
                              lm_masks, inter_masks, *weights)


def apply_train_fused(params: dict, cfg, emb_inputs, enc_states, enc_lens,
                      flags, gumbel, lm_masks, inter_masks=()):
    """The fused form of attn_decoder.apply_train for GRU decoders (same
    noise, same function): emb_inputs [T,B,emb] -> logits [T-1,B,V].

    flags [T-1] 0/1 sampling coins and gumbel [T-1,B,V] (None without
    scheduled sampling); lm_masks [T-1,B,G] float dropout masks or None;
    inter_masks the [T-1,B,D] masks between stacked decoder cells."""
    dec_train.check_supported(params)
    T, B, emb_size = emb_inputs.shape
    steps = T - 1
    lm = params["lm_cell"]
    x = emb_inputs[:steps]
    tgx = x @ lm["gates"]["kernel"][:emb_size] + lm["gates"]["bias"]
    tcx = x @ lm["candidate"]["kernel"][:emb_size] + lm["candidate"]["bias"]
    weights = weight_args(params, emb_size)
    hf = enc_states @ params["attn_w"]
    gum_sh, flag_sh = dec_train.shift_noise(flags, gumbel, B)
    lm_masks, inter = dec_train.stack_masks(lm_masks, inter_masks, steps, B)
    return dec_train_gru([w.contiguous() for w in weights], hf.contiguous(),
                         enc_states.contiguous(),
                         dec_train.attn_mask(enc_states, enc_lens),
                         tgx.contiguous(), tcx.contiguous(), gum_sh, flag_sh,
                         lm_masks, inter, sp="simple_proj" in params)
