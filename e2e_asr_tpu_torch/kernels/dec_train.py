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

Envelope: LSTM cells, one decoder layer, no SimpleProjection (the flagship
decoder). Anything else raises NotImplementedError on the card; the CPU
runs the plain scan in models/attn_decoder.py.
"""
from __future__ import annotations

import torch

from e2e_asr_tpu_torch.core.cells import _lstm_apply_gates
from e2e_asr_tpu_torch.kernels import build

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
NEG_INF = -1e30

# Indices into the weights tuple of `weight_args`.
W_NAMES = ("ewb", "wlmh", "ipw", "ipb", "decw", "decb", "qw", "qb", "v",
           "apw", "apb", "opw", "opb")


def check_supported(params: dict) -> None:
    """LSTM decoder params (GRU decoders take kernels/dec_train_gru.py) of
    one layer without SimpleProjection."""
    if len(params["dec_cells"]) != 1 or "simple_proj" in params:
        raise NotImplementedError(
            "the fused training decoder takes one decoder layer and no "
            "SimpleProjection (ROADMAP.md Queue 2, 'dec_train: deeper "
            "decoders')")


def weight_args(params: dict, emb_size: int) -> tuple:
    """The decoder weights in the kernel's order (W_NAMES). ewb is the
    embedding through the LM cell's input kernel with its bias folded in;
    ind_softmax swaps in the decoder's own output projection."""
    lm = params["lm_cell"]
    op = params["output_proj_ind" if "output_proj_ind" in params
                else "output_proj"]
    ewb = params["embedding"] @ lm["kernel"][:emb_size] + lm["bias"]
    dec = params["dec_cells"][0]
    return (ewb, lm["kernel"][emb_size:], params["input_proj"]["kernel"],
            params["input_proj"]["bias"], dec["kernel"], dec["bias"],
            params["attn_query"]["kernel"], params["attn_query"]["bias"],
            params["attn_v"], params["attn_proj"]["kernel"],
            params["attn_proj"]["bias"], op["kernel"], op["bias"])


def dec_train_reference(weights, hf, enc, amask, tlmx, gum_sh, flag_sh,
                        lm_masks, sampled=None):
    """Plain PyTorch version of the forward kernel (its backward is
    autograd's). weights: `weight_args`; hf [B,T,A]; enc [B,T,E]; amask
    [B,T]; tlmx [S,B,4G]; gum_sh [S,B,V] and flag_sh [S,B] (row t holds step
    t-1's noise and coin, row 0 zero) or None; lm_masks [S,B,G] or None.
    sampled [S,B]: replay these sampled tokens instead of taking the argmax
    (to hold a kernel's run to this one past a near-tie). Returns logits
    [S,B,V]."""
    ewb, wlmh, ipw, ipb, decw, decb, qw, qb, v, apw, apb, opw, opb = weights
    S, B, G4 = tlmx.shape
    G = G4 // 4
    D = decb.shape[0] // 4
    M = decw.shape[0] - D
    zeros = tlmx.new_zeros
    h_lm, c_lm, h, c = zeros(B, G), zeros(B, G), zeros(B, D), zeros(B, D)
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
        x_dec = lm_out @ ipw[:G] + ctx @ ipw[G:] + ipb
        h, (c, _) = _lstm_apply_gates(x_dec @ decw[:M] + h @ decw[M:] + decb,
                                      c, D)
        y = c @ qw + qb
        s = torch.sum(v * torch.tanh(hf + y[:, None, :]), dim=-1)
        s = torch.where(amask > 0, s, torch.full_like(s, NEG_INF))
        alpha = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bt,bte->be", alpha, enc)
        logits = (c @ apw[:D] + ctx @ apw[D:] + apb) @ opw + opb
        out.append(logits)
    return torch.stack(out)


def _dims(weights, hf, enc, tlmx):
    ewb, wlmh, ipw, _, decw, decb, qw = weights[:7]
    S, B, G4 = tlmx.shape
    D = decb.shape[0] // 4
    return (S, B, G4 // 4, D, decw.shape[0] - D, enc.shape[-1], qw.shape[1],
            ewb.shape[0], enc.shape[1])


def _check(weights, hf, enc, amask, tlmx, gum_sh, flag_sh, lm_masks, dims):
    S, B, G, D, M, E, A, V, T = dims
    dev = tlmx.device
    shapes = ((V, 4 * G), (G, 4 * G), (G + E, M), (M,), (M + D, 4 * D),
              (4 * D,), (D, A), (A,), (A,), (D + E, D), (D,), (D, V), (V,))
    f32, req = torch.float32, build.require
    for name, w, shape in zip(W_NAMES, weights, shapes):
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


class _DecTrain(torch.autograd.Function):
    """Forward kernel #8 (saves every intermediate) and backward kernel #9."""

    @staticmethod
    def forward(ctx, hf, enc, amask, tlmx, gum_sh, flag_sh, lm_masks,
                *weights):
        global FWD_LAUNCHES
        dims = _dims(weights, hf, enc, tlmx)
        _check(weights, hf, enc, amask, tlmx, gum_sh, flag_sh, lm_masks, dims)
        S, B, G, D, M, E, A, V, T = dims
        dev = tlmx.device
        zeros = torch.zeros(B * max(G, D, E), device=dev)
        widths = dict(logits=V, gates_lm=4 * G, hlm=G, clm=G, lm_out=G,
                      x_dec=M, gates_dec=4 * D, hdec=D, cdec=D, y=A,
                      alpha=T, ctx=E, proj=D)
        saves = {k: torch.empty(S, B, w, device=dev)
                 for k, w in widths.items()}
        saves["oh"] = (torch.zeros(S, B, V, device=dev)
                       if gum_sh is not None else None)
        ptr_list = [*weights, hf, enc, amask, tlmx, gum_sh, flag_sh, lm_masks,
                    zeros, *saves.values()]
        lib = build.library()
        with torch.cuda.device(dev):
            err = lib.e2e_dec_train_fwd(build.ptrs(*ptr_list), len(ptr_list),
                                        build.ints(*dims),
                                        build.stream_ptr(dev))
        build.check(err, "dec_train_fwd")
        FWD_LAUNCHES += 1
        ctx.dims = dims
        ctx.save_for_backward(hf, enc, amask, flag_sh, lm_masks, zeros,
                              *weights, *[saves[k] for k in (
                                  "gates_lm", "clm", "hlm", "lm_out", "x_dec",
                                  "gates_dec", "hdec", "cdec", "y", "alpha",
                                  "ctx", "proj", "oh")])
        return saves["logits"]

    @staticmethod
    def backward(ctx, dlogits):
        global BWD_LAUNCHES
        S, B, G, D, M, E, A, V, T = dims = ctx.dims
        hf, enc, amask, flag_sh, lm_masks, zeros, *rest = ctx.saved_tensors
        weights, saves = rest[:13], rest[13:]
        (_, wlmh, ipw, _, decw, _, qw, _, v, apw, _, opw, _) = weights
        dev = hf.device
        transposed = [w.t().contiguous() for w in (opw, apw, qw, decw, ipw,
                                                   wlmh)]
        new = lambda *shape: torch.empty(*shape, device=dev)  # noqa: E731
        steps = [new(S, B, w) for w in (D, A, 4 * D, M, 4 * G)]
        dtlmx, dhf, denc = new(S, B, 4 * G), new(B, T, A), new(B, T, E)
        dweights = [new(*w.shape) for w in weights]
        scratch = [new(B, w) for w in (D + E, A, D, D, G, G, E)]
        ptr_list = [*transposed, v, hf, enc, amask, flag_sh, lm_masks, zeros,
                    *saves, dlogits.contiguous(), *steps, dtlmx, dhf, denc,
                    *dweights, *scratch]
        lib = build.library()
        with torch.cuda.device(dev):
            err = lib.e2e_dec_train_bwd(build.ptrs(*ptr_list), len(ptr_list),
                                        build.ints(*dims),
                                        build.stream_ptr(dev))
        build.check(err, "dec_train_bwd")
        BWD_LAUNCHES += 1
        return (dhf, denc, None, dtlmx, None, None, None, *dweights)


def dec_train(weights, hf, enc, amask, tlmx, gum_sh=None, flag_sh=None,
              lm_masks=None):
    """Logits [S,B,V] of the whole training pass (arguments as
    `dec_train_reference`); differentiable on both devices."""
    if tlmx.device.type == "cpu":
        return dec_train_reference(weights, hf, enc, amask, tlmx, gum_sh,
                                   flag_sh, lm_masks)
    if tlmx.device.type != "cuda":
        raise ValueError(f"dec_train: unsupported device {tlmx.device}")
    return _DecTrain.apply(hf, enc, amask, tlmx, gum_sh, flag_sh, lm_masks,
                           *weights)


def apply_train_fused(params: dict, cfg, emb_inputs, enc_states, enc_lens,
                      flags, gumbel, lm_masks):
    """The fused form of attn_decoder.apply_train (same noise, same
    function): emb_inputs [T,B,emb] -> logits [T-1,B,V].

    flags [T-1] 0/1 sampling coins and gumbel [T-1,B,V] (None without
    scheduled sampling); lm_masks [T-1,B,G] float dropout masks or None."""
    check_supported(params)
    T, B, emb_size = emb_inputs.shape
    steps = T - 1
    lm = params["lm_cell"]
    tlmx = emb_inputs[:steps] @ lm["kernel"][:emb_size] + lm["bias"]
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
    return dec_train([w.contiguous() for w in weights], hf.contiguous(),
                     enc_states.contiguous(), amask, tlmx.contiguous(),
                     gum_sh, flag_sh, lm_masks)


def sampled_tokens(logits, gum_sh):
    """The tokens a run with these logits samples: [S,B], row t the argmax
    (lowest index on ties) of logits[t-1] + gum_sh[t] (row 0: zeros)."""
    idx = torch.argmax(logits[:-1] + gum_sh[1:], dim=-1)
    return torch.cat([torch.zeros_like(idx[:1]), idx])
