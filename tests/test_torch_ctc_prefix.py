"""Kernel #16's plain version, the CTC prefix scorer and joint
CTC/attention beam decoding of the port on the CPU, against the JAX
package and against brute-force enumeration:

- `prefix_scan_reference` against the Pallas `prefix_scan` in interpret
  mode on one set of inputs (T = 13, not a multiple of the TPU kernel's
  8-frame block; rows at NEG_INF, repeat masks, fresh and mid-decode
  rows), one test per row;
- `CTCPrefixScorer.step` (deltas, the candidates' forward variables) and
  `select` against JAX's (its XLA frame scan), from a fresh and a
  mid-decode state, full vocabulary and pre-beam (P < V, and P = k
  where pre_beam < k);
- psi(g) = log P(the collapsed output begins with g) and the <eos> delta
  = log P(the collapsed output is g) against every alignment enumerated,
  at T = 4, V = 5;
- a joint beam decode (`beam_decode` with a scorer) against JAX's, on the
  same decoder weights (the port's init, carried across by name), encoder
  states and CTC logits;
- the route (the per-step kernels at every batch size) and the scorer's
  properties (enc_lens, pre-beam covering, joint weight 0).

Tolerances (float32; the recurrence's values reach tens of nats here):
forward variables and deltas 1e-5 relative to max(|value|, 1), entries
at NEG_INF (< NEG_INF / 2) on both sides held by that threshold;
probabilities against enumeration 1e-4 relative; beam scores 1e-4;
tokens exactly. Each JAX function compiles once, in a module fixture.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_tpu.config import BeamConfig as JBeamConfig
from e2e_asr_tpu.config import DecoderConfig as JDecoderConfig
from e2e_asr_tpu.core import checkpoint as jckpt
from e2e_asr_tpu.eval import beam as jbeam
from e2e_asr_tpu.eval.ctc_prefix import CTCPrefixScorer as JScorer
from e2e_asr_tpu.models import attn_decoder as jdec
from e2e_asr_tpu.ops import ctc_prefix_pallas as cpp
from e2e_asr_tpu_torch.config import BeamConfig, DecoderConfig
from e2e_asr_tpu_torch.core import checkpoint
from e2e_asr_tpu_torch.eval import beam
from e2e_asr_tpu_torch.eval.ctc_prefix import NEG_INF, CTCPrefixScorer
from e2e_asr_tpu_torch.kernels import beam_mega, ctc_prefix
from e2e_asr_tpu_torch.models import attn_decoder

torch.set_num_threads(1)
REL = 1e-5


def quick_jit(fn, *args):
    """fn(*args) compiled with XLA's backend optimizations off (the same
    float32 operations) for about half the compile time."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})(*args)


def assert_scan_close(got, want, what: str = ""):
    """Values within REL of max(|want|, 1); entries below NEG_INF / 2 on
    either side below it on both."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    neg_g, neg_w = got < NEG_INF / 2, want < NEG_INF / 2
    np.testing.assert_array_equal(neg_g, neg_w, err_msg=what)
    fin = ~neg_w
    err = np.abs(got[fin] - want[fin]) / np.maximum(np.abs(want[fin]), 1.0)
    assert err.size == 0 or err.max() <= REL, (what, err.max())


# -- kernel #16: the plain version against the Pallas kernel -------------

T_K, BK_K, P_K = 13, 8, 6


def scan_inputs():
    """One beam step's scan inputs: row 0 fresh (phi0 = 0, rn_par at
    NEG_INF, rb_par finite), rows 1-4 mid-decode (phi0 at NEG_INF), row 5
    with rn_par and rb_par at NEG_INF (a dead parent), row 6 with its
    frames past 9 at NEG_INF (a shorter utterance), row 7 with rb_par at
    NEG_INF for 4 frames; one repeat-masked candidate in every row."""
    rng = np.random.default_rng(16)
    f = lambda *s: (rng.normal(size=s) - 2.0).astype(np.float32)  # noqa
    xc, xb = f(T_K, BK_K, P_K), f(T_K, BK_K, 1)
    rn_par, rb_par = f(T_K, BK_K, 1) * 3, f(T_K, BK_K, 1) * 3
    phi0 = np.full((BK_K, P_K), NEG_INF, np.float32)
    phi0[0] = 0.0
    rn_par[:, 0] = NEG_INF
    rn_par[:, 5] = rb_par[:, 5] = NEG_INF
    xc[9:, 6] = xb[9:, 6] = NEG_INF
    rb_par[:4, 7] = NEG_INF
    allow_neg = np.zeros((BK_K, P_K), np.float32)
    allow_neg[np.arange(BK_K), np.arange(BK_K) % P_K] = NEG_INF
    return xc, xb, rn_par, rb_par, allow_neg, phi0


@pytest.fixture(scope="module")
def pallas_scan():
    args = scan_inputs()
    want = quick_jit(cpp.prefix_scan, *map(jnp.asarray, args))
    got = ctc_prefix.prefix_scan_reference(*map(torch.tensor, args))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("row", range(BK_K))
def test_plain_scan_matches_pallas(pallas_scan, row):
    """psi [BK, P] and rn, rb [T, BK, P] of one row against the Pallas
    kernel in interpret mode."""
    (psi_w, rn_w, rb_w), (psi_g, rn_g, rb_g) = pallas_scan
    assert rn_g.shape == rn_w.shape == (T_K, BK_K, P_K)
    assert_scan_close(psi_g[row], psi_w[row], "psi")
    assert_scan_close(rn_g[:, row], rn_w[:, row], "rn")
    assert_scan_close(rb_g[:, row], rb_w[:, row], "rb")


def test_scan_rows_cover_the_cases(pallas_scan):
    """The rows exercise finite values and NEG_INF entries in every
    output, and the repeat mask changes psi (row 1 against the same row
    unmasked)."""
    _, (psi, rn, rb) = pallas_scan
    for x in (psi, rn, rb):
        assert (x < NEG_INF / 2).any() and (x > -1e3).any()
    args = [torch.tensor(a) for a in scan_inputs()]
    free = list(args)
    free[4] = torch.zeros_like(args[4])
    phi_masked = ctc_prefix.prefix_scan_reference(*args)[0][1]
    phi_free = ctc_prefix.prefix_scan_reference(*free)[0][1]
    assert not torch.equal(phi_masked, phi_free)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """prefix_scan on CPU tensors is the plain version, launches nothing,
    and raises for a device that is neither the CPU nor CUDA."""
    args = [torch.tensor(a) for a in scan_inputs()]
    before = ctc_prefix.LAUNCHES
    for a, b in zip(ctc_prefix.prefix_scan(*args),
                    ctc_prefix.prefix_scan_reference(*args)):
        assert torch.equal(a, b)
    assert ctc_prefix.LAUNCHES == before
    with pytest.raises(ValueError, match="device"):
        ctc_prefix.prefix_scan(*[a.to("meta") for a in args])


# -- the scorer against JAX's ---------------------------------------------

STEP_CASES = [(2, 3, 9, 12, None), (2, 2, 16, 20, 5), (1, 3, 13, 10, 2)]


def step_inputs(case_id: int):
    """Frame logits, lengths, attention log-probs, a mid-decode state
    (NEG_INF slots, `last` = -1 rows) and a (parent, token) selection for
    STEP_CASES[case_id]."""
    B, k, T, V, pre = STEP_CASES[case_id]
    rng = np.random.default_rng(100 + case_id)
    logits = rng.normal(size=(B, T, V)).astype(np.float32)
    lens = rng.integers(2, T + 1, size=B).astype(np.int32)
    att = rng.normal(size=(B, k, V)).astype(np.float32)
    rn = rng.normal(size=(B, k, T)).astype(np.float32) - 2.0
    rn[:, -1, :] = NEG_INF
    rb = rng.normal(size=(B, k, T)).astype(np.float32) - 2.0
    state = {"rn": rn, "rb": rb,
             "psi": rng.normal(size=(B, k)).astype(np.float32),
             "last": rng.integers(-1, 5, size=(B, k)).astype(np.int32)}
    parent = rng.integers(0, k, size=(B, k)).astype(np.int32)
    pos = rng.integers(0, min(V, max(pre or V, k)), size=(B, k, 1))
    return (logits, lens, att, state, parent, pos), pre


def _jax_steps(all_inputs):
    """JAX's step and select of every case, fresh and mid-decode."""
    out = []
    for (logits, lens, att, state, parent, pos), pre in all_inputs:
        scorer = JScorer(logits, lens, pre_beam=pre)
        for st in (scorer.init_state(att.shape[1]), state):
            delta, cand = scorer.step(st, att)
            token = jnp.take_along_axis(jnp.take_along_axis(
                cand["cand"], parent[..., None], 1), pos, -1)[..., 0]
            out.append((delta, cand, token,
                        scorer.select(cand, parent, token), st["rb"]))
    return out


@pytest.fixture(scope="module")
def jax_steps():
    inputs = [step_inputs(i) for i in range(len(STEP_CASES))]
    arrays = [(tuple(jax.tree_util.tree_map(jnp.asarray, x)), pre)
              for x, pre in inputs]
    run = lambda a: _jax_steps([(x, pre) for x, (_, pre) in  # noqa
                                zip(a, arrays)])
    return inputs, quick_jit(run, [x for x, _ in arrays])


@pytest.mark.parametrize("case_id,fresh", itertools.product(
    range(len(STEP_CASES)), (True, False)))
def test_scorer_step_and_select_match_jax(jax_steps, case_id, fresh):
    inputs, outs = jax_steps
    (logits, lens, att, state, parent, pos), pre = inputs[case_id]
    w_delta, w_cand, w_token, w_sel, w_rb = outs[2 * case_id
                                                 + (0 if fresh else 1)]
    scorer = CTCPrefixScorer(torch.tensor(logits), torch.tensor(lens),
                             pre_beam=pre)
    k = att.shape[1]
    st = (scorer.init_state(k) if fresh else
          {key: torch.tensor(v) for key, v in state.items()})
    delta, cand = scorer.step(st, torch.tensor(att))
    np.testing.assert_array_equal(cand["cand"].numpy(), w_cand["cand"])
    assert_scan_close(delta.numpy(), w_delta, "delta")
    for key in ("rn", "rb", "psi"):
        assert_scan_close(cand[key].numpy(), w_cand[key], key)
    token = torch.tensor(np.asarray(w_token))
    sel = scorer.select(cand, torch.tensor(parent), token)
    for key in ("rn", "rb", "psi"):
        assert_scan_close(sel[key].numpy(), w_sel[key], f"select {key}")
    np.testing.assert_array_equal(sel["last"].numpy(), w_sel["last"])
    assert_scan_close(st["rb"].numpy(), w_rb, "init rb")


# -- the prefix probability against enumeration ----------------------------

def _collapse(path, blank=0):
    out, prev = [], -1
    for p in path:
        if p != blank and p != prev:
            out.append(p)
        prev = p
    return tuple(out)


def exact_probs(probs):
    """probs [T, V] -> ({prefix: P(collapsed output begins with it)},
    {sequence: P(collapsed output is it)}) over every alignment."""
    T, V = probs.shape
    prefix, complete = {}, {}
    for path in itertools.product(range(V), repeat=T):
        p = float(np.prod([probs[t, v] for t, v in enumerate(path)]))
        lab = _collapse(path)
        complete[lab] = complete.get(lab, 0.0) + p
        for n in range(len(lab) + 1):
            prefix[lab[:n]] = prefix.get(lab[:n], 0.0) + p
    return prefix, complete


@pytest.fixture(scope="module")
def enumerated():
    """Two frame-posterior sets (T = 4, V = 5; blank 0, <eos> 2) with
    their exact prefix and complete probabilities."""
    out = {}
    for seed in (0, 1):
        logits = (np.random.default_rng(seed).normal(size=(1, 4, 5))
                  * 1.2).astype(np.float32)
        probs = torch.softmax(torch.tensor(logits[0]), -1).double().numpy()
        out[seed] = (logits, *exact_probs(probs))
    return out


def walk(scorer, seq, V):
    """The scorer driven along `seq` at k = 1: (state, delta of the next
    step)."""
    B = scorer.B
    state = scorer.init_state(1)
    zero = torch.zeros(B, 1, dtype=torch.int32)
    for c in seq:
        _, cand = scorer.step(state, torch.zeros(B, 1, V))
        state = scorer.select(cand, zero, torch.full((B, 1), c))
    return state, scorer.step(state, torch.zeros(B, 1, V))[0]


@pytest.mark.parametrize("seed,seq", itertools.product(
    (0, 1), [s for n in (1, 2) for s in itertools.product((1, 3, 4),
                                                          repeat=n)]))
def test_prefix_probability_equals_enumeration(enumerated, seed, seq):
    logits, prefix, complete = enumerated[seed]
    scorer = CTCPrefixScorer(torch.tensor(logits), torch.tensor([4]))
    state, delta = walk(scorer, seq, 5)
    psi = float(state["psi"][0, 0])
    np.testing.assert_allclose(np.exp(psi), prefix.get(seq, 0.0), rtol=1e-4,
                               atol=1e-12)
    np.testing.assert_allclose(np.exp(psi + float(delta[0, 0, 2])),
                               complete.get(seq, 0.0), rtol=1e-4, atol=1e-12)
    assert float(delta[0, 0, 0]) < NEG_INF / 2     # blank never extends


def test_empty_prefix_complete_probability(enumerated):
    """From the fresh state the <eos> delta is log P(empty output) and
    each label's delta is log P(output begins with it)."""
    logits, prefix, complete = enumerated[0]
    scorer = CTCPrefixScorer(torch.tensor(logits), torch.tensor([4]))
    delta, _ = scorer.step(scorer.init_state(1), torch.zeros(1, 1, 5))
    np.testing.assert_allclose(np.exp(float(delta[0, 0, 2])),
                               complete[()], rtol=1e-4)
    for c in (1, 3, 4):
        np.testing.assert_allclose(np.exp(float(delta[0, 0, c])),
                                   prefix[(c,)], rtol=1e-4)


def test_scorer_respects_enc_lens():
    """Frames past an utterance's length contribute nothing: padded
    scoring equals scoring the truncated frames."""
    logits = np.random.default_rng(3).normal(size=(2, 6, 5)).astype(
        np.float32)
    full = CTCPrefixScorer(torch.tensor(logits), torch.tensor([6, 4]))
    trunc = CTCPrefixScorer(torch.tensor(logits[1:, :4]), torch.tensor([4]))
    for seq in [(1,), (3, 4), (1, 1)]:
        s_f, d_f = walk(full, seq, 5)
        s_t, d_t = walk(trunc, seq, 5)
        np.testing.assert_allclose(float(s_f["psi"][1, 0]),
                                   float(s_t["psi"][0, 0]), rtol=1e-5)
        assert_scan_close(d_f[1].numpy(), d_t[0].numpy())


def test_pre_beam_covering_equals_full_vocabulary():
    """pre_beam = V scores exactly what the full vocabulary does, and a
    pre-beam below V scores NEG_INF off its candidates."""
    rng = np.random.default_rng(4)
    logits = torch.tensor(rng.normal(size=(2, 5, 6)).astype(np.float32))
    att = torch.tensor(rng.normal(size=(2, 3, 6)).astype(np.float32))
    lens = torch.tensor([5, 3])
    full = CTCPrefixScorer(logits, lens)
    d_full, _ = full.step(full.init_state(3), att)
    pre = CTCPrefixScorer(logits, lens, pre_beam=6)
    d_pre, _ = pre.step(pre.init_state(3), att)
    np.testing.assert_allclose(d_pre.numpy(), d_full.numpy(), rtol=1e-6)
    small = CTCPrefixScorer(logits, lens, pre_beam=3)
    d_small, cand = small.step(small.init_state(3), att)
    off = torch.ones_like(d_small, dtype=torch.bool)
    off.scatter_(2, cand["cand"], False)
    off[:, :, 2] = False                          # <eos> is always scored
    assert (d_small[off] < NEG_INF / 2).all()


# -- joint CTC/attention beams ---------------------------------------------

DEC = dict(hidden_size_dec=8, emb_size=8, vocab_size=9, attention_vec_size=8,
           lm_hidden_size=8, samp_prob=0.0, out_prob_dec=1.0, max_output=8)
BEAMS = [(3, 0.3, 0, 3), (4, 0.5, 3, 1)]   # k, w, pre, B


def beam_inputs(B: int, seed: int):
    """Decoder weights for both packages, encoder states [B, 5, 8] (scaled
    so the decoder is peaked), ragged lengths and CTC logits [B, 5, 9]."""
    params = attn_decoder.init(torch.Generator().manual_seed(seed),
                               DecoderConfig(**DEC), 8, device="cpu")
    shapes = jax.eval_shape(lambda: jdec.init(
        jax.random.PRNGKey(0), JDecoderConfig(**DEC), attn_size=8))
    jparams = jax.tree_util.tree_map(jnp.asarray, jckpt.unflatten_named(
        shapes, checkpoint.named_from_params(params)))
    rng = np.random.default_rng(seed)
    enc = (rng.normal(size=(B, 5, 8)) * 2).astype(np.float32)
    lens = np.array([5, 4, 3][:B], np.int32)
    logits = (rng.normal(size=(B, 5, 9)) * 2).astype(np.float32)
    return params, jparams, enc, lens, logits


def jbeam_cfg(k, w, pre):
    return JBeamConfig(beam_size=k, max_steps=8, joint_ctc=w,
                       ctc_pre_beam=pre)


@pytest.fixture(scope="module")
def jax_beams():
    cases = [beam_inputs(B, 30 + i) for i, (_, _, _, B) in enumerate(BEAMS)]

    def run(jps, encs, lenss, logitss):
        return [jbeam.beam_decode(
            jp, JDecoderConfig(**DEC), jbeam_cfg(k, w, pre), e, n,
            ctc_scorer=JScorer(lg, n, pre_beam=pre or None))
            for jp, e, n, lg, (k, w, pre, _) in
            zip(jps, encs, lenss, logitss, BEAMS)]

    args = [[c[i] for c in cases] for i in (1, 2, 3, 4)]
    return cases, quick_jit(run, *args)


@pytest.mark.parametrize("case_id", range(len(BEAMS)))
def test_joint_beam_decode_matches_jax(jax_beams, case_id, monkeypatch):
    """Tokens and lengths exactly, scores within 1e-4; at B = 1 the joint
    beam keeps off kernel #15's route, as the reference's gate does."""
    cases, outs = jax_beams
    k, w, pre, B = BEAMS[case_id]
    params, _, enc, lens, logits = cases[case_id]
    monkeypatch.setattr(beam_mega, "beam_decode_mega", None)
    tokens, out_lens, scores = beam.beam_decode(
        params, DecoderConfig(**DEC), BeamConfig(
            beam_size=k, max_steps=8, joint_ctc=w, ctc_pre_beam=pre),
        torch.tensor(enc), torch.tensor(lens),
        ctc_scorer=CTCPrefixScorer(torch.tensor(logits), torch.tensor(lens),
                                   pre_beam=pre or None))
    want_tok, want_lens, want_scores = (np.asarray(x) for x in outs[case_id])
    np.testing.assert_array_equal(out_lens.numpy(), want_lens)
    for b in range(B):
        n = int(want_lens[b])
        np.testing.assert_array_equal(tokens[b, :n].numpy(),
                                      want_tok[b, :n])
    np.testing.assert_allclose(scores.numpy(), want_scores, rtol=1e-4,
                               atol=1e-4)
    assert not beam.takes_mega(params, BeamConfig(beam_size=k), B,
                               joint=True)


def test_joint_weight_zero_is_the_plain_beam():
    """joint_ctc = 0 ignores the scorer: the per-step beam's output; at a
    weight above 0 the CTC evidence changes the scores."""
    params, _, enc, lens, logits = beam_inputs(3, 40)
    args = (params, DecoderConfig(**DEC))
    enc_t, lens_t = torch.tensor(enc), torch.tensor(lens)
    scorer = CTCPrefixScorer(torch.tensor(logits), lens_t)
    plain = beam.beam_decode_steps(*args, BeamConfig(beam_size=3,
                                                     max_steps=8),
                                   enc_t, lens_t)
    zero = beam.beam_decode(*args, BeamConfig(beam_size=3, max_steps=8,
                                              joint_ctc=0.0),
                            enc_t, lens_t, ctc_scorer=scorer)
    joint = beam.beam_decode(*args, BeamConfig(beam_size=3, max_steps=8,
                                               joint_ctc=0.5),
                             enc_t, lens_t, ctc_scorer=scorer)
    for a, b in zip(plain, zero):
        assert torch.equal(a, b)
    assert not torch.allclose(joint[2], plain[2])
