"""Kernel #13 (`attn_output_fused`: the additive attention folded into
kernel C) in the port on the CPU:

- its plain version against JAX's Pallas kernel in interpret mode, at k=1
  (the greedy step) and k=3 (a beam step), with a padded frame mask and a
  vocabulary that is not a multiple of 128: log-probs, context and alpha
  within 1e-5 absolute (values of order 1, float32 sums in another order),
  alpha exactly 0 on padded frames. The port's rows are b-major (b*k + j),
  the Pallas kernel's k-major (j*B + b);
- its route: with E2E_ASR_FUSED_ATTN set (read at each call, as the JAX
  package reads it) the greedy decode and the per-step beam search of an
  LSTM and of a GRU decoder take #13 in place of the attention and kernel
  C, and decode the same ids (and beam scores within 1e-4) as without it;
- bf16 raises, as for kernels B and C.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_tpu.ops import dec_step_pallas as dsp
from e2e_asr_tpu_torch.config import BeamConfig
from e2e_asr_tpu_torch.eval import beam
from e2e_asr_tpu_torch.kernels import attn_output
from e2e_asr_tpu_torch.models import attn_decoder
from tests.test_torch_beam_mega import _assert_same, _both
from tests.test_torch_train_step import quick_jit

torch.set_num_threads(1)
ATOL = 1e-5


def _k_major(a, k):
    """The port's rows b*k + j in the Pallas kernel's order j*B + b."""
    return a.reshape(-1, k, a.shape[-1]).swapaxes(0, 1).reshape(a.shape)


def _b_major(a, k):
    """The Pallas kernel's rows j*B + b in the port's order b*k + j."""
    return a.reshape(k, -1, a.shape[-1]).swapaxes(0, 1).reshape(a.shape)


@pytest.mark.parametrize("k", [1, 3])
def test_attn_output_matches_pallas(k):
    cfg, params, jcfg, jparams, enc, lens = _both(
        np.random.default_rng(k), 2, vocab_size=11)
    B, T = enc.shape[:2]
    rng = np.random.default_rng(10 + k)
    y = rng.normal(size=(B * k, 8)).astype(np.float32)
    query = rng.normal(size=(B * k, 8)).astype(np.float32)
    ctx = attn_decoder.make_attn_context(params, torch.tensor(enc),
                                         torch.tensor(lens))
    assert float(ctx.mask.sum()) < B * T               # a padded tail
    args = (jparams, jnp.asarray(_k_major(y, k)),
            jnp.asarray(_k_major(query, k)),
            jnp.asarray(ctx.hidden_features.numpy()),
            jnp.asarray(ctx.enc_states.numpy()), jnp.asarray(ctx.mask.numpy()))
    want = quick_jit(lambda p, *a: dsp.attn_output_fused(
        p, jcfg, *a, k=k, bf16=False), *args)(*args)
    before = attn_output.LAUNCHES
    got = attn_output.attn_output_fused(
        params, cfg, torch.tensor(y), torch.tensor(query),
        ctx.hidden_features, ctx.enc_states, ctx.mask, k=k)
    assert attn_output.LAUNCHES == before               # the plain version
    assert [tuple(g.shape) for g in got] == [(B * k, 11), (B * k, 8),
                                             (B * k, T)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _b_major(np.asarray(w), k),
                                   atol=ATOL, rtol=0)
    alpha = got[2].view(B, k, T)
    assert bool((alpha[ctx.mask[:, None].expand_as(alpha) == 0] == 0).all())


@pytest.mark.parametrize("use_lstm", [True, False])
def test_route_opt_in(use_lstm, monkeypatch):
    cfg, params, _, _, enc, lens = _both(
        np.random.default_rng(7), 3, use_lstm=use_lstm)
    enc, lens = torch.tensor(enc), torch.tensor(lens)
    calls = []
    fused = attn_output.attn_output_fused
    monkeypatch.setattr(attn_output, "attn_output_fused", lambda *a, **kw:
                        calls.append(kw["k"]) or fused(*a, **kw))
    outputs = []
    bc = BeamConfig(beam_size=3, max_steps=6)
    monkeypatch.delenv("E2E_ASR_FUSED_ATTN", raising=False)
    for opt_in in (False, True):
        if opt_in:
            monkeypatch.setenv("E2E_ASR_FUSED_ATTN", "1")
        greedy = attn_decoder.apply_infer_early(
            params, cfg, torch.ones(3, dtype=torch.long), enc, lens,
            max_output=6)
        outputs.append((greedy, beam.beam_decode_steps(params, cfg, bc, enc,
                                                       lens)))
        assert bool(calls) == opt_in
    assert set(calls) == {1, 3}
    assert torch.equal(outputs[0][0], outputs[1][0])
    _assert_same(outputs[1][1], outputs[0][1])


def test_bf16_raises():
    """bf16 matmuls are not ported: #13 raises naming its ROADMAP item, as
    kernels B and C do, before any work."""
    cfg, params, _, _, enc, lens = _both(np.random.default_rng(2), 1)
    ctx = attn_decoder.make_attn_context(params, torch.tensor(enc),
                                         torch.tensor(lens))
    with pytest.raises(NotImplementedError, match="Decode features"):
        attn_output.attn_output_fused(
            params, cfg, torch.zeros(1, 8), torch.zeros(1, 8),
            ctx.hidden_features, ctx.enc_states, ctx.mask, k=1, bf16=True)
