"""Port parity: kernels B (cells_fused) and C (output_fused) of one decode
step, against the JAX package's Pallas kernels in interpret mode (f32).

Tolerance: 1e-5 absolute, float32 sums taken in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_tpu.config import DecoderConfig
from e2e_asr_tpu.core.cells import LSTMState as JState
from e2e_asr_tpu.models import attn_decoder as jdec
from e2e_asr_tpu.ops import dec_step_pallas as dsp
from e2e_asr_tpu_torch.core.cells import LSTMState
from e2e_asr_tpu_torch.kernels import dec_step
from e2e_asr_tpu_torch.models import attn_decoder

torch.set_num_threads(1)
ATOL = 1e-5
H_ENC = 10
VARIANTS = {
    "one_layer": {},
    "two_layers": {"num_layers_dec": 2},
    "simple_proj": {"lm_hidden_size": 12},
    "two_layers_simple_proj": {"num_layers_dec": 2, "lm_hidden_size": 12},
}


def _setup(seed, N=6, **kw):
    base = dict(hidden_size_dec=8, emb_size=7, vocab_size=11,
                attention_vec_size=5, lm_hidden_size=8, out_prob_dec=1.0)
    base.update(kw)
    cfg = DecoderConfig(**base)
    params = jdec.init(jax.random.PRNGKey(seed), cfg, attn_size=H_ENC)
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    H, Hl = cfg.hidden_size_dec, cfg.lm_hidden_size
    inputs = dict(x_emb=f(N, cfg.emb_size), ctx=f(N, H_ENC),
                  lm=(f(N, Hl), f(N, Hl)),
                  dec=tuple((f(N, H), f(N, H))
                            for _ in range(cfg.num_layers_dec)),
                  query=f(N, H), context=f(N, H_ENC))
    return cfg, params, inputs


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _jax_cells(params, inp):
    return dsp.cells_fused(
        params, jnp.asarray(inp["x_emb"]), jnp.asarray(inp["ctx"]),
        JState(*map(jnp.asarray, inp["lm"])),
        tuple(JState(*map(jnp.asarray, s)) for s in inp["dec"]),
        use_lstm=True, bf16=False)


def _port_cells(params, inp):
    t = torch.tensor
    return dec_step.cells_fused(
        _torch(params), t(inp["x_emb"]), t(inp["ctx"]),
        LSTMState(*map(t, inp["lm"])),
        tuple(LSTMState(*map(t, s)) for s in inp["dec"]))


def _leaves(out):
    new_lm, new_dec, y = out
    return [new_lm.c, new_lm.h, *[x for s in new_dec for x in s], y]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cells_fused_matches_pallas(variant):
    cfg, params, inp = _setup(0, **VARIANTS[variant])
    want = _leaves(_jax_cells(params, inp))
    got = _leaves(_port_cells(params, inp))
    assert len(got) == len(want) == 3 + 2 * cfg.num_layers_dec
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("ind_softmax", [False, True])
def test_output_fused_matches_pallas(ind_softmax):
    cfg, params, inp = _setup(1, ind_softmax=ind_softmax)
    want = dsp.output_fused(params, cfg, jnp.asarray(inp["query"]),
                            jnp.asarray(inp["context"]), bf16=False)
    got = dec_step.output_fused(_torch(params), cfg,
                                torch.tensor(inp["query"]),
                                torch.tensor(inp["context"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_unported_options_raise():
    cfg, params, inp = _setup(2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dec_step.output_fused(_torch(params), cfg, torch.tensor(inp["query"]),
                              torch.tensor(inp["context"]), bf16=True)
    before = (dec_step.CELLS_LAUNCHES, dec_step.OUTPUT_LAUNCHES)
    _port_cells(params, inp)
    assert (dec_step.CELLS_LAUNCHES, dec_step.OUTPUT_LAUNCHES) == before


def test_attention_matches_jax():
    """The additive attention between B and C (masked softmax on ragged
    encoder lengths) against the JAX decoder's attention."""
    cfg, params, inp = _setup(4)
    rng = np.random.default_rng(4)
    enc = rng.normal(size=(3, 9, H_ENC)).astype(np.float32)
    lens = np.array([9, 4, 1], np.int32)
    query = rng.normal(size=(3, cfg.hidden_size_dec)).astype(np.float32)
    want = jdec.attention(params, jdec.make_attn_context(
        params, jnp.asarray(enc), jnp.asarray(lens)), jnp.asarray(query))
    tp = _torch(params)
    got = attn_decoder.attention(tp, attn_decoder.make_attn_context(
        tp, torch.tensor(enc), torch.tensor(lens)), torch.tensor(query))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)
