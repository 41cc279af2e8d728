"""Kernels #8 and #9: the attention decoder's whole training pass, forward
and backward, one cooperative launch each (`csrc/dec_train.cu`).

Replaces e2e_asr_tpu/ops/dec_train_pallas.py `apply_train_fused` (:735):
the forward kernel `_fwd_call` (teacher forcing with scheduled sampling
from pre-shifted gumbel noise, dropout masks handed in) and the backward
kernel `_bwd_call`, with the weights in the order of `_weight_args` (:252).

Bound on the H100: latency. A step is a chain of about eight dependent
products over B rows and about 5 MiB of f32 weights; at B = 128 none of
them fills the card and the 47 steps are serial, so the plain version's
cost is its hundreds of small launches per step. Design (see the CUDA
source): one persistent cooperative launch per direction, grid barriers
between the dependent stages of a step, tiles of 8 rows x 32 columns from
csrc/tiles.cuh; the forward saves every intermediate, the backward computes
the data gradients step by step in reverse and then the weight gradients,
each 64 x 64 tile of a dW accumulated over all rows and steps by the block
that owns it (no atomics, a fixed order).

The products the reference leaves to XLA stay outside, in PyTorch, so
autograd carries their gradients on: tlmx = emb_in @ W_lm_x + b,
EWb = embedding @ W_lm_x + b and hf = enc @ attn_w.

Envelope: LSTM cells, the whole decoder space of the reference: 1 to 8
stacked decoder cells (`MAX_LAYERS`, the decode kernels' cap) with their
inter-layer dropout masks, SimpleProjection when lm_hidden != hidden, and
ind_softmax (the decoder's own output projection). A deeper stack raises
ValueError naming its depth on the card; the CPU runs the plain scan in
models/attn_decoder.py.
"""
from __future__ import annotations

import torch

from e2e_asr_tpu_torch.core.cells import _lstm_apply_gates
from e2e_asr_tpu_torch.kernels import build

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
DEPTHS = {}          # decoder layers -> forward launches at that depth
NEG_INF = -1e30
MAX_LAYERS = 8       # csrc/dec_train.cuh kMaxLayers

# Indices into the weights tuple of `weight_args`: these 13, then (kernel,
# bias) of each decoder layer above the first, then SimpleProjection's
# (kernel, bias) where the decoder has it.
W_NAMES = ("ewb", "wlmh", "ipw", "ipb", "decw", "decb", "qw", "qb", "v",
           "apw", "apb", "opw", "opb")


def check_supported(params: dict) -> None:
    """Decoder params (LSTM here, GRU in kernels/dec_train_gru.py) of at
    most MAX_LAYERS stacked cells."""
    n = len(params["dec_cells"])
    if not 1 <= n <= MAX_LAYERS:
        raise ValueError(f"the fused training decoder takes 1 to "
                         f"{MAX_LAYERS} decoder layers, not {n}")


def weight_args(params: dict, emb_size: int) -> tuple:
    """The decoder weights in the kernel's order (W_NAMES, then the deeper
    layers' kernel and bias, then SimpleProjection's), the order of the
    reference's _weight_args with each layer's kernel kept whole. ewb is the
    embedding through the LM cell's input kernel with its bias folded in;
    ind_softmax swaps in the decoder's own output projection."""
    lm = params["lm_cell"]
    op = params["output_proj_ind" if "output_proj_ind" in params
                else "output_proj"]
    ewb = params["embedding"] @ lm["kernel"][:emb_size] + lm["bias"]
    dec = params["dec_cells"][0]
    out = [ewb, lm["kernel"][emb_size:], params["input_proj"]["kernel"],
           params["input_proj"]["bias"], dec["kernel"], dec["bias"],
           params["attn_query"]["kernel"], params["attn_query"]["bias"],
           params["attn_v"], params["attn_proj"]["kernel"],
           params["attn_proj"]["bias"], op["kernel"], op["bias"]]
    for cell in params["dec_cells"][1:]:
        out += [cell["kernel"], cell["bias"]]
    if "simple_proj" in params:
        out += [params["simple_proj"]["kernel"], params["simple_proj"]["bias"]]
    return tuple(out)


def _split(weights, sp: bool):
    """(the 13 fixed weights, [(kernel, bias)] of every decoder layer,
    (spw, spb) or None)."""
    fixed = weights[:13]
    rest = weights[13:len(weights) - (2 if sp else 0)]
    layers = [(fixed[4], fixed[5])] + [(rest[i], rest[i + 1])
                                       for i in range(0, len(rest), 2)]
    return fixed, layers, (tuple(weights[-2:]) if sp else None)


def dec_train_reference(weights, hf, enc, amask, tlmx, gum_sh, flag_sh,
                        lm_masks, inter_masks=None, sampled=None, *,
                        sp: bool = False):
    """Plain PyTorch version of the forward kernel (its backward is
    autograd's). weights: `weight_args`; sp: whether they end with
    SimpleProjection's; hf [B,T,A]; enc [B,T,E]; amask [B,T]; tlmx [S,B,4G];
    gum_sh [S,B,V] and flag_sh [S,B] (row t holds step t-1's noise and coin,
    row 0 zero) or None; lm_masks [S,B,G] or None; inter_masks [NL-1,S,B,D]
    (the dropout masks between stacked cells) or None. sampled [S,B]:
    replay these sampled tokens instead of taking the argmax (to hold a
    kernel's run to this one past a near-tie). Returns logits [S,B,V]."""
    fixed, layers, spp = _split(weights, sp)
    ewb, wlmh, ipw, ipb, _, _, qw, qb, v, apw, apb, opw, opb = fixed
    S, B, G4 = tlmx.shape
    G = G4 // 4
    D = layers[0][1].shape[0] // 4
    HID = D if sp else G
    zeros = tlmx.new_zeros
    h_lm, c_lm = zeros(B, G), zeros(B, G)
    hs = [zeros(B, D) for _ in layers]
    cs = [zeros(B, D) for _ in layers]
    ctx = zeros(B, enc.shape[-1])
    logits = zeros(B, opb.shape[0])
    out = []
    for t in range(S):
        lmx = tlmx[t]
        if gum_sh is not None and t > 0:
            idx = (torch.argmax(logits.detach() + gum_sh[t], dim=-1)
                   if sampled is None else sampled[t])
            flag = flag_sh[t][:, None]
            lmx = flag * ewb[idx] + (1.0 - flag) * lmx
        h_lm, (c_lm, _) = _lstm_apply_gates(lmx + h_lm @ wlmh, c_lm, G)
        lm_out = h_lm * lm_masks[t] if lm_masks is not None else h_lm
        if spp is not None:
            lm_out = lm_out @ spp[0] + spp[1]
        inp = lm_out @ ipw[:HID] + ctx @ ipw[HID:] + ipb
        for l, (w, b) in enumerate(layers):
            K = w.shape[0] - D
            hs[l], (cs[l], _) = _lstm_apply_gates(
                inp @ w[:K] + hs[l] @ w[K:] + b, cs[l], D)
            inp = hs[l]
            if inter_masks is not None and l < len(layers) - 1:
                inp = inp * inter_masks[l][t]
        c = cs[-1]
        y = c @ qw + qb
        s = torch.sum(v * torch.tanh(hf + y[:, None, :]), dim=-1)
        s = torch.where(amask > 0, s, torch.full_like(s, NEG_INF))
        alpha = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bt,bte->be", alpha, enc)
        logits = (c @ apw[:D] + ctx @ apw[D:] + apb) @ opw + opb
        out.append(logits)
    return torch.stack(out)


def _dims(weights, enc, tlmx, sp: bool):
    _, layers, _ = _split(weights, sp)
    ewb, qw = weights[0], weights[6]
    decw, decb = layers[0]
    S, B, G4 = tlmx.shape
    D = decb.shape[0] // 4
    return (S, B, G4 // 4, D, decw.shape[0] - D, enc.shape[-1], qw.shape[1],
            ewb.shape[0], enc.shape[1], len(layers))


def _check(weights, hf, enc, amask, tlmx, gum_sh, flag_sh, lm_masks,
           inter_masks, dims, sp):
    S, B, G, D, M, E, A, V, T, NL = dims
    if not 1 <= NL <= MAX_LAYERS:
        raise ValueError(f"dec_train: {NL} decoder layers; the kernel takes "
                         f"1 to {MAX_LAYERS}")
    HID = D if sp else G
    dev = tlmx.device
    shapes = [(V, 4 * G), (G, 4 * G), (HID + E, M), (M,), (M + D, 4 * D),
              (4 * D,), (D, A), (A,), (A,), (D + E, D), (D,), (D, V), (V,)]
    names = list(W_NAMES)
    for l in range(1, NL):
        shapes += [(2 * D, 4 * D), (4 * D,)]
        names += [f"decw{l}", f"decb{l}"]
    if sp:
        shapes += [(G, D), (D,)]
        names += ["spw", "spb"]
    if len(weights) != len(shapes):
        raise ValueError(f"dec_train: {len(weights)} weights, expected "
                         f"{len(shapes)}")
    f32, req = torch.float32, build.require
    for name, w, shape in zip(names, weights, shapes):
        req(w, name, f32, shape, dev)
    req(hf, "hf", f32, (B, T, A), dev)
    req(enc, "enc", f32, (B, T, E), dev)
    req(amask, "amask", f32, (B, T), dev)
    req(tlmx, "tlmx", f32, (S, B, 4 * G), dev)
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


class _DecTrain(torch.autograd.Function):
    """Forward kernel #8 (saves every intermediate) and backward kernel #9."""

    @staticmethod
    def forward(ctx, sp, hf, enc, amask, tlmx, gum_sh, flag_sh, lm_masks,
                inter_masks, *weights):
        global FWD_LAUNCHES
        dims = _dims(weights, enc, tlmx, sp)
        _check(weights, hf, enc, amask, tlmx, gum_sh, flag_sh, lm_masks,
               inter_masks, dims, sp)
        S, B, G, D, M, E, A, V, T, NL = dims
        dev = tlmx.device
        zeros = torch.zeros(B * max(G, D, E), device=dev)
        new = lambda *shape: torch.empty(*shape, device=dev)  # noqa: E731
        widths = dict(logits=V, gates_lm=4 * G, hlm=G, clm=G, lm_out=G,
                      x_dec=M)
        saves = {k: new(S, B, w) for k, w in widths.items()}
        saves.update(gates_dec=new(NL, S, B, 4 * D), hdec=new(NL, S, B, D),
                     cdec=new(NL, S, B, D))
        for k, w in dict(y=A, alpha=T, ctx=E, proj=D).items():
            saves[k] = new(S, B, w)
        saves["oh"] = (torch.zeros(S, B, V, device=dev)
                       if gum_sh is not None else None)
        lm_sp = new(S, B, D) if sp else None
        hdrop = new(NL - 1, S, B, D) if NL > 1 else None
        fixed, layers, spp = _split(weights, sp)
        ptr_list = [*fixed, hf, enc, amask, tlmx, gum_sh, flag_sh, lm_masks,
                    zeros, *saves.values(), *(spp or (None, None)), lm_sp,
                    inter_masks, hdrop,
                    *[w for layer in layers[1:] for w in layer]]
        lib = build.library()
        with torch.cuda.device(dev):
            err = lib.e2e_dec_train_fwd(build.ptrs(*ptr_list), len(ptr_list),
                                        build.ints(*dims),
                                        build.stream_ptr(dev))
        build.check(err, "dec_train_fwd")
        FWD_LAUNCHES += 1
        DEPTHS[NL] = DEPTHS.get(NL, 0) + 1
        ctx.dims, ctx.sp = dims, sp
        ctx.save_for_backward(hf, enc, amask, flag_sh, lm_masks, inter_masks,
                              zeros, lm_sp, hdrop, *weights,
                              *[saves[k] for k in (
                                  "gates_lm", "clm", "hlm", "lm_out", "x_dec",
                                  "gates_dec", "hdec", "cdec", "y", "alpha",
                                  "ctx", "proj", "oh")])
        return saves["logits"]

    @staticmethod
    def backward(ctx, dlogits):
        global BWD_LAUNCHES
        S, B, G, D, M, E, A, V, T, NL = dims = ctx.dims
        sp = ctx.sp
        (hf, enc, amask, flag_sh, lm_masks, inter_masks, zeros, lm_sp, hdrop,
         *rest) = ctx.saved_tensors
        n_w = len(rest) - 13
        weights, saves = rest[:n_w], rest[n_w:]
        fixed, layers, spp = _split(weights, sp)
        (_, wlmh, ipw, _, _, _, qw, _, v, apw, _, opw, _) = fixed
        dev = hf.device
        T_ = lambda w: w.t().contiguous()  # noqa: E731
        transposed = [T_(w) for w in (opw, apw, qw, layers[0][0], ipw, wlmh)]
        new = lambda *shape: torch.empty(*shape, device=dev)  # noqa: E731
        steps = [new(S, B, D), new(S, B, A), new(NL, S, B, 4 * D),
                 new(S, B, M), new(S, B, 4 * G)]
        dtlmx, dhf, denc = new(S, B, 4 * G), new(B, T, A), new(B, T, E)
        dfixed = [new(*w.shape) for w in fixed]
        scratch = [new(B, D + E), new(B, A), new(NL, B, D), new(NL, B, D),
                   new(B, G), new(B, G), new(B, E)]
        dsp = new(S, B, D) if sp else None
        dspp = [new(*w.shape) for w in spp] if sp else [None, None]
        dlayers = [(new(*w.shape), new(*b.shape)) for w, b in layers[1:]]
        ptr_list = [*transposed, v, hf, enc, amask, flag_sh, lm_masks, zeros,
                    *saves, dlogits.contiguous(), *steps, dtlmx, dhf, denc,
                    *dfixed, *scratch, T_(spp[0]) if sp else None, lm_sp, dsp,
                    inter_masks, hdrop, *dspp]
        for (w, _), (dw, db) in zip(layers[1:], dlayers):
            ptr_list += [T_(w), dw, db]
        lib = build.library()
        with torch.cuda.device(dev):
            err = lib.e2e_dec_train_bwd(build.ptrs(*ptr_list), len(ptr_list),
                                        build.ints(*dims),
                                        build.stream_ptr(dev))
        build.check(err, "dec_train_bwd")
        BWD_LAUNCHES += 1
        dweights = [*dfixed, *[g for pair in dlayers for g in pair]]
        if sp:
            dweights += dspp
        return (None, dhf, denc, None, dtlmx, None, None, None, None,
                *dweights)


def dec_train(weights, hf, enc, amask, tlmx, gum_sh=None, flag_sh=None,
              lm_masks=None, inter_masks=None, *, sp: bool = False):
    """Logits [S,B,V] of the whole training pass (arguments as
    `dec_train_reference`); differentiable on both devices."""
    if tlmx.device.type == "cpu":
        return dec_train_reference(weights, hf, enc, amask, tlmx, gum_sh,
                                   flag_sh, lm_masks, inter_masks, sp=sp)
    if tlmx.device.type != "cuda":
        raise ValueError(f"dec_train: unsupported device {tlmx.device}")
    return _DecTrain.apply(sp, hf, enc, amask, tlmx, gum_sh, flag_sh,
                           lm_masks, inter_masks, *weights)


def shift_noise(flags, gumbel, B: int):
    """(gum_sh [S,B,V], flag_sh [S,B]) from a pass's coins flags [S] and
    gumbel [S,B,V]: step t reads step t-1's logits and noise, and row 0 is
    teacher-forced. (None, None) without scheduled sampling."""
    if gumbel is None:
        return None, None
    steps, _, V = gumbel.shape
    gum_sh = torch.cat([gumbel.new_zeros(1, B, V), gumbel[:-1]])
    flag_sh = torch.cat([flags.new_zeros(1), flags[:-1]])[:, None].expand(
        steps, B).contiguous()
    return gum_sh, flag_sh


def stack_masks(lm_masks, inter_masks, steps: int, B: int):
    """The dropout masks as the kernels take them: lm_masks [S,B,G] and
    inter_masks [NL-1,S,B,D] (None where there are none)."""
    if lm_masks is None:
        return None, None
    lm_masks = lm_masks.expand(steps, B, -1).contiguous()
    if not inter_masks:
        return lm_masks, None
    return lm_masks, torch.stack([m.expand(steps, B, -1)
                                  for m in inter_masks]).contiguous()


def attn_mask(enc_states, enc_lens):
    """[B, T_enc] float validity of the encoder frames."""
    T_enc = enc_states.shape[1]
    return (torch.arange(T_enc, device=enc_states.device)[None, :]
            < enc_lens.to(enc_states.device).long()[:, None]).float()


def apply_train_fused(params: dict, cfg, emb_inputs, enc_states, enc_lens,
                      flags, gumbel, lm_masks, inter_masks=()):
    """The fused form of attn_decoder.apply_train (same noise, same
    function): emb_inputs [T,B,emb] -> logits [T-1,B,V].

    flags [T-1] 0/1 sampling coins and gumbel [T-1,B,V] (None without
    scheduled sampling); lm_masks [T-1,B,G] float dropout masks or None;
    inter_masks the [T-1,B,D] masks between stacked decoder cells (empty
    without dropout or at one layer)."""
    check_supported(params)
    T, B, emb_size = emb_inputs.shape
    steps = T - 1
    lm = params["lm_cell"]
    tlmx = emb_inputs[:steps] @ lm["kernel"][:emb_size] + lm["bias"]
    weights = weight_args(params, emb_size)
    hf = enc_states @ params["attn_w"]
    gum_sh, flag_sh = shift_noise(flags, gumbel, B)
    lm_masks, inter = stack_masks(lm_masks, inter_masks, steps, B)
    return dec_train([w.contiguous() for w in weights], hf.contiguous(),
                     enc_states.contiguous(), attn_mask(enc_states, enc_lens),
                     tlmx.contiguous(), gum_sh, flag_sh, lm_masks, inter,
                     sp="simple_proj" in params)


def sampled_tokens(logits, gum_sh):
    """The tokens a run with these logits samples: [S,B], row t the argmax
    (lowest index on ties) of logits[t-1] + gum_sh[t] (row 0: zeros)."""
    idx = torch.argmax(logits[:-1] + gum_sh[1:], dim=-1)
    return torch.cat([torch.zeros_like(idx[:1]), idx])
