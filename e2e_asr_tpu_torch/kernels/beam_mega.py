"""Kernel #15: the whole beam search of a small batch in one launch
(`csrc/beam_mega.cu`).

Replaces: e2e_asr_tpu/ops/beam_megakernel.py `beam_decode_mega`, which the
reference's beam search takes at B <= 2 (eval/beam.py routes to it).

Computes what eval/beam.py's per-step search computes, with the same
contract: up to max_steps steps, stopping once no hypothesis is live, each
step the decoder cells (LSTM or GRU; the attention query is the top c of
LSTM cells and the top h of GRU cells), the additive attention over the
precomputed hidden features, the output projections and log_softmax, the
top-k selection with the k-slot finished buffer and the word-insertion
penalty, and the parents' states gathered into compacted live slots (a GRU
carries h alone); then the best of finished u live. Returns (tokens [B, S]
int64, lens [B] int64, scores [B] float32); positions past a length are
0.

Bound on the H100: the serial chain of about 10 + L small dependent
stages a step; at B=1, k=4 a step is about 12 MFLOP over 6 MB of weights
that stay in L2. The per-step route pays a host round trip per operation
instead (about 1.5 ms of host time a step).

Design: one cooperative persistent launch with a grid barrier between the
stages (details in the source). Its own limits, which eval/beam.py checks
from the shapes before it takes this route (`fits`): beam size k <= 16,
k * V <= 8192 candidates (they sit in the selection block's shared
memory), at most 8 decoder layers, B <= 64; LSTM or GRU cells, float32. A
GRU cell takes two grid barriers where an LSTM cell takes one (its
candidate's recurrent product needs all of r*h).

`trace=True` also returns each step's selection, {"vals" [steps, B, k]
float32, "parent", "token" [steps, B, k] int32}, for holding the kernel to
its plain version where two float32 decodes part at a near-tie.
"""
from __future__ import annotations

import torch

from e2e_asr_tpu_torch.core.cells import (LSTMState, gru_zero_state,
                                          lstm_zero_state)
from e2e_asr_tpu_torch.data.text import EOS_ID, GO_ID
from e2e_asr_tpu_torch.kernels import attn_output, beam_select, build, dec_step

NEG_INF = beam_select.NEG_INF
MAX_BEAM = 16
MAX_CANDIDATES = 8192
MAX_LAYERS = 8
LAUNCHES = 0        # with LSTM cells
GRU_LAUNCHES = 0    # with GRU cells


def fits(beam_size: int, vocab_size: int, num_layers: int) -> bool:
    """Whether the kernel takes these shapes (its limits besides B)."""
    return (1 <= beam_size <= MAX_BEAM
            and beam_size * vocab_size <= MAX_CANDIDATES
            and 1 <= num_layers <= MAX_LAYERS)


def _map(fn, state):
    """fn over a cell state: both halves of an LSTMState, a GRU's h."""
    if isinstance(state, LSTMState):
        return LSTMState(*map(fn, state))
    return fn(state)


@torch.no_grad()
def search(params: dict, cfg, beam_cfg, enc, hf, mask, *, cells, output,
           select, attn=None, trace: bool = False):
    """The beam search a step at a time, over N = B*k rows (row = b*k + j):
    cells(params, x, context, lm_state, dec_states, use_lstm=) ->
    (lm_state, dec_states, query projection y), the additive attention
    (`attn_output.attend`), output(params, cfg, query, context) ->
    log-probs [N, V], or in their place attn(params, cfg, y, query, hf,
    enc, mask, k=) -> (log-probs, context, alpha) where given (kernel #13's
    signature), select(scores, logp, alive, num_finished, eos_id=) ->
    kernel #14's dict, then the finished buffer, the compaction of the live
    slots (empty ones zero) and the best of finished u live. The query is
    the top cell's c for LSTM cells and its h for GRU cells. With the plain
    versions of #11, #12 and #14 it is the plain version of this kernel;
    with the kernels, eval/beam.py's per-step route. Arguments and results
    as `beam_decode_mega`'s."""
    B, _, Henc = enc.shape
    k, S = beam_cfg.beam_size, beam_cfg.max_steps
    dev = enc.device
    emb = params["embedding"]
    zero = lstm_zero_state if cfg.use_lstm else gru_zero_state
    lm = zero((B * k,), cfg.lm_hidden_size, device=dev)
    dec = tuple(zero((B * k,), cfg.hidden_size_dec, device=dev)
                for _ in params["dec_cells"])
    context = torch.zeros(B * k, Henc, device=dev)
    inputs = emb[torch.full((B * k,), GO_ID, device=dev)]
    alive = (torch.arange(k, device=dev) == 0).repeat(B, 1)
    scores = torch.where(alive, 0.0, NEG_INF)
    seqs = torch.zeros(B, k, S, dtype=torch.long, device=dev)
    fin_count = torch.zeros(B, dtype=torch.int32, device=dev)
    # Finished buffer; slot k takes what the selection drops.
    fin_scores = torch.full((B, k + 1), NEG_INF, device=dev)
    fin_seqs = torch.zeros(B, k + 1, S, dtype=torch.long, device=dev)
    fin_lens = torch.zeros(B, k + 1, dtype=torch.long, device=dev)
    rows = torch.arange(B, device=dev)[:, None]
    steps = []
    t = 0
    while t < S and bool(alive.any()):
        lm_new, dec_new, y = cells(params, inputs, context, lm, dec,
                                   use_lstm=cfg.use_lstm)
        query = dec_new[-1].c if cfg.use_lstm else dec_new[-1]
        if attn is not None:
            logp, ctx_new, _ = attn(params, cfg, y, query, hf, enc, mask, k=k)
        else:
            ctx_new, _ = attn_output.attend(params, y, hf, enc, mask, k=k)
            logp = output(params, cfg, query, ctx_new)
        sel = select(scores, logp.view(B, k, -1), alive, fin_count,
                     eos_id=EOS_ID)
        if trace:
            steps.append([sel[key] for key in ("vals", "parent", "token")])
        parent, token = sel["parent"].long(), sel["token"].long()
        stored = sel["vals"] + beam_cfg.word_ins_penalty * (t + 1)
        cand = seqs[rows, parent]
        cand[:, :, t] = token
        dest = sel["fin_dest"].long()
        fin_scores[rows, dest] = stored
        fin_seqs[rows, dest] = cand
        fin_lens[rows, dest] = t + 1
        fin_count = fin_count + sel["fin_sel"].sum(1, dtype=torch.int32)
        # Live slots in rank order from their parents; empty slots zero.
        order = sel["order"].long()
        alive = sel["slot_valid"] > 0
        src = (rows * k + torch.gather(parent, 1, order)).flatten()
        keep = alive.reshape(-1, 1)
        take = lambda x: torch.where(keep, x[src], 0.0)  # noqa: E731
        lm = _map(take, lm_new)
        dec = tuple(_map(take, d) for d in dec_new)
        context = take(ctx_new)
        inputs = torch.where(
            keep, emb[torch.gather(token, 1, order).flatten()], 0.0)
        seqs = torch.where(alive[:, :, None], cand[rows, order], 0)
        scores = torch.where(alive, torch.gather(stored, 1, order), NEG_INF)
        t += 1

    all_scores = torch.cat([fin_scores[:, :k], scores], dim=1)
    all_seqs = torch.cat([fin_seqs[:, :k], seqs], dim=1)
    all_lens = torch.cat([fin_lens[:, :k], torch.full_like(fin_lens[:, :k],
                                                          t)], dim=1)
    best = torch.argmax(all_scores, dim=1)
    b = torch.arange(B, device=dev)
    out = (all_seqs[b, best], all_lens[b, best], all_scores[b, best])
    if not trace:
        return out
    empty = [torch.zeros(0, B, k, dtype=dt, device=dev)
             for dt in (torch.float32, torch.int32, torch.int32)]
    stacked = [torch.stack(x) for x in zip(*steps)] if steps else empty
    return (*out, dict(zip(("vals", "parent", "token"), stacked)))


def beam_decode_mega_reference(params: dict, cfg, beam_cfg, enc, hf, mask,
                               *, trace: bool = False):
    """Plain PyTorch version of the kernel: the same arguments and results.
    enc [B, T, H_enc], hf = enc @ attn_w [B, T, A], mask [B, T] 1/0."""
    return search(params, cfg, beam_cfg, enc, hf, mask,
                  cells=dec_step.cells_fused_reference,
                  output=dec_step.output_fused_reference,
                  select=beam_select.beam_select_reference, trace=trace)


def beam_decode_mega(params: dict, cfg, beam_cfg, enc, hf, mask, *,
                     trace: bool = False):
    """The whole search in one launch on the card; the plain version for
    tensors on the CPU. Arguments and results as the plain version's."""
    global LAUNCHES, GRU_LAUNCHES
    if enc.device.type == "cpu":
        return beam_decode_mega_reference(params, cfg, beam_cfg, enc, hf,
                                          mask, trace=trace)
    if enc.device.type != "cuda":
        raise ValueError(f"beam_decode_mega: unsupported device {enc.device}")
    dev = enc.device
    B, T, Henc = enc.shape
    k, S = beam_cfg.beam_size, beam_cfg.max_steps
    V, E = params["embedding"].shape
    Hl, H = cfg.lm_hidden_size, cfg.hidden_size_dec
    A = params["attn_query"]["kernel"].shape[-1]
    L = len(params["dec_cells"])
    if not fits(k, V, L):
        raise ValueError(f"beam_decode_mega: beam {k}, vocabulary {V} and "
                         f"{L} decoder layers exceed the kernel's limits "
                         f"(k <= {MAX_BEAM}, k*V <= {MAX_CANDIDATES}, "
                         f"L <= {MAX_LAYERS})")
    sp = params.get("simple_proj")
    out = dec_step.out_proj(params, cfg)
    f32 = torch.float32
    req = build.require
    req(enc, "enc", f32, (B, T, Henc), dev)
    req(hf, "hf", f32, (B, T, A), dev)
    req(mask, "mask", f32, (B, T), dev)
    req(params["embedding"], "embedding", f32, (V, E), dev)
    req(params["attn_v"], "attn_v", f32, (A,), dev)
    weights = {"input_proj": (params["input_proj"], H + Henc, E),
               "attn_query": (params["attn_query"], H, A),
               "attn_proj": (params["attn_proj"], H + Henc, H),
               "output_proj": (out, H, V)}
    if sp is not None:
        weights["simple_proj"] = (sp, Hl, H)
    # An LSTM cell: (kernel, bias); a GRU cell: (gates kernel, bias,
    # candidate kernel, bias), the gates split r | u.
    cell_ptrs = []
    for name, cp, in_dim, hid in (
            ("lm_cell", params["lm_cell"], E, Hl),
            *((f"dec_cells/{layer}", cp, E if layer == 0 else H, H)
              for layer, cp in enumerate(params["dec_cells"]))):
        if cfg.use_lstm:
            weights[name] = (cp, in_dim + hid, 4 * hid)
            cell_ptrs.append([cp["kernel"], cp["bias"], None, None])
        else:
            weights[f"{name}/gates"] = (cp["gates"], in_dim + hid, 2 * hid)
            weights[f"{name}/candidate"] = (cp["candidate"], in_dim + hid,
                                            hid)
            cell_ptrs.append([cp["gates"]["kernel"], cp["gates"]["bias"],
                              cp["candidate"]["kernel"],
                              cp["candidate"]["bias"]])
    for name, (w, fan_in, fan_out) in weights.items():
        req(w["kernel"], f"{name}/kernel", f32, (fan_in, fan_out), dev)
        req(w["bias"], f"{name}/bias", f32, (fan_out,), dev)

    lib = build.library()
    dims = build.ints(B, k, T, Henc, E, Hl, H, A, V, L, S, EOS_ID, GO_ID,
                      int(sp is not None), int(not cfg.use_lstm))
    counts = (torch.zeros(2, dtype=torch.int64))
    build.check(lib.e2e_beam_mega_scratch(dims, len(dims), counts.data_ptr()),
                "beam_decode_mega")
    scratch_f = torch.empty(int(counts[0]), dtype=f32, device=dev)
    scratch_i = torch.empty(int(counts[1]), dtype=torch.int32, device=dev)
    tokens = torch.empty(B, S, dtype=torch.long, device=dev)
    lens = torch.empty(B, dtype=torch.long, device=dev)
    scores = torch.empty(B, dtype=f32, device=dev)
    tr = [None] * 3
    if trace:   # steps never run keep parent -1
        tr = [torch.full((S, B, k), float("nan"), device=dev),
              torch.full((S, B, k), -1, dtype=torch.int32, device=dev),
              torch.full((S, B, k), -1, dtype=torch.int32, device=dev)]
    ptr_list = [enc, hf, mask, params["embedding"], params["attn_v"],
                *cell_ptrs[0], None if sp is None else sp["kernel"],
                None if sp is None else sp["bias"],
                params["input_proj"]["kernel"], params["input_proj"]["bias"],
                params["attn_query"]["kernel"], params["attn_query"]["bias"],
                params["attn_proj"]["kernel"], params["attn_proj"]["bias"],
                out["kernel"], out["bias"]]
    for ptrs in cell_ptrs[1:]:
        ptr_list += ptrs
    ptr_list += [tokens, lens, scores, *tr, scratch_f, scratch_i]
    with torch.cuda.device(dev):
        err = lib.e2e_beam_mega(build.ptrs(*ptr_list), len(ptr_list), dims,
                                len(dims), float(beam_cfg.word_ins_penalty),
                                build.stream_ptr(dev))
    build.check(err, "beam_decode_mega")
    if cfg.use_lstm:
        LAUNCHES += 1
    else:
        GRU_LAUNCHES += 1
    if not trace:
        return tokens, lens, scores
    ran = int((tr[1][:, 0, 0] >= 0).sum())
    return tokens, lens, scores, dict(zip(("vals", "parent", "token"),
                                          (x[:ran] for x in tr)))


def parting(got, want, near_tie: float) -> list:
    """Where two traced decodes of one batch (the results of trace=True)
    part: per utterance None where they give the same tokens and length,
    else (step, rank, gap) of the first selection that differs, gap being
    the two selection values' difference there. Raises ValueError where
    they part otherwise than at a near-tie: selection values that differ by
    near_tie or more up to the parting, or different outputs from the same
    selections. (Two float32 decodes may part at a near-tie.)"""
    tok_a, len_a, _, tr_a = got
    tok_b, len_b, _, tr_b = want
    out = []
    for b in range(tok_a.shape[0]):
        n = int(len_a[b])
        if n == int(len_b[b]) and torch.equal(tok_a[b, :n], tok_b[b, :n]):
            out.append(None)
            continue
        for s in range(min(len(tr_a["vals"]), len(tr_b["vals"]))):
            va, vb = tr_a["vals"][s, b], tr_b["vals"][s, b]
            gap = (va - vb).abs()
            same = ((tr_a["parent"][s, b] == tr_b["parent"][s, b])
                    & (tr_a["token"][s, b] == tr_b["token"][s, b]))
            r = int((~same).nonzero()[0]) if not bool(same.all()) else None
            worst = float(gap[:r].max()) if r != 0 else 0.0
            if worst >= near_tie:
                raise ValueError(f"utterance {b}, step {s}: selection values "
                                 f"differ by {worst} before any parting")
            if r is not None:
                if float(gap[r]) >= near_tie:
                    raise ValueError(f"utterance {b} parts at step {s}, rank "
                                     f"{r} by {float(gap[r])}")
                out.append((s, r, float(gap[r])))
                break
        else:
            raise ValueError(f"utterance {b}: the same selections give "
                             "different outputs")
    return out
