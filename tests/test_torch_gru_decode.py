"""Port parity for decoding GRU decoders on the CPU, against the JAX
package on the same weights:

- kernel #11's GRU branch (`dec_step.cells_fused(use_lstm=False)`, its
  plain version on the CPU), two layers with SimpleProjection, against
  JAX's Pallas `cells_fused` in interpret mode: 1e-5 absolute (values of
  order 1, float32 sums in another order);
- kernel #15's GRU branch (`beam_decode_mega_reference`) against JAX's
  `beam_decode_mega` (Pallas, interpret mode) and its XLA `beam_decode`,
  after tests/test_beam.py's GRU oracle case (B=2, k=3, 8 steps): token ids
  up to the length and lengths exactly, scores within 1e-4 (sums of up to 8
  float32 log-probs);
- end to end, the `-gru` char + phone model (GRU encoder and decoders)
  whose weights pass through `core/checkpoint` both ways: the port's greedy
  decode (`seq2seq.apply_greedy`) against JAX's (`apply_infer_early`) and
  the port's `beam_decode` by either route against JAX's, ids exactly;
- the decode's entry checks: GRU decoders pass, the transformer raises.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_tpu.config import BeamConfig as JBeamConfig
from e2e_asr_tpu.config import LMConfig
from e2e_asr_tpu.core import checkpoint as jckpt
from e2e_asr_tpu.eval import beam as jbeam
from e2e_asr_tpu.models import seq2seq as jseq2seq
from e2e_asr_tpu.ops import beam_megakernel as jmega
from e2e_asr_tpu.ops import dec_step_pallas as dsp
from e2e_asr_tpu.train import step as jstep
from e2e_asr_tpu_torch.config import BeamConfig
from e2e_asr_tpu_torch.core import checkpoint
from e2e_asr_tpu_torch.eval import beam, greedy
from e2e_asr_tpu_torch.kernels import beam_mega, dec_step
from e2e_asr_tpu_torch.models import seq2seq
from e2e_asr_tpu_torch.train import step
from tests.test_torch_beam_mega import _assert_same, _both, _reference
from tests.test_torch_dec_train_gru import gru_cfg
from tests.test_torch_train_step import init_both, make_batch, quick_jit

torch.set_num_threads(1)
ATOL = 1e-5


def test_cells_fused_gru_matches_pallas():
    """Two GRU decoder layers with SimpleProjection: the new LM and layer
    states (bare h) and the query projection of the top h."""
    _, params, _, jparams, _, _ = _both(np.random.default_rng(5), 1,
                                        use_lstm=False, num_layers_dec=2,
                                        lm_hidden_size=12)
    assert "simple_proj" in params
    rng = np.random.default_rng(5)
    N = 6
    inputs = [rng.normal(size=(N, w)).astype(np.float32)
              for w in (8, 8, 12, 8, 8)]          # x, ctx, lm h, 2 layers' h
    args = (jparams, *map(jnp.asarray, inputs[:3]),
            tuple(map(jnp.asarray, inputs[3:])))
    want_lm, want_dec, want_y = quick_jit(
        lambda *a: dsp.cells_fused(*a, use_lstm=False, bf16=False),
        *args)(*args)
    x, ctx, lm, *dec = map(torch.tensor, inputs)
    before = dec_step.CELLS_GRU_LAUNCHES
    got_lm, got_dec, got_y = dec_step.cells_fused(params, x, ctx, lm,
                                                  tuple(dec), use_lstm=False)
    assert dec_step.CELLS_GRU_LAUNCHES == before     # the plain version
    assert len(got_dec) == 2
    for g, w in zip([got_lm, *got_dec, got_y],
                    [want_lm, *want_dec, want_y]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


def test_beam_mega_gru_matches_pallas_and_xla(rng):
    """#15's plain version with a GRU decoder against the Pallas kernel and
    the XLA beam search, two utterances of unequal lengths."""
    cfg, params, jcfg, jparams, enc, lens = _both(rng, 2, use_lstm=False)
    bc = dict(beam_size=3, max_steps=8)
    want_mega = jmega.beam_decode_mega(jparams, jcfg, JBeamConfig(**bc),
                                       jnp.asarray(enc), jnp.asarray(lens))
    want_xla = quick_jit(lambda p, e, n: jbeam.beam_decode(
        p, jcfg, JBeamConfig(**bc), e, n), jparams, jnp.asarray(enc),
        jnp.asarray(lens))(jparams, jnp.asarray(enc), jnp.asarray(lens))
    before = beam_mega.GRU_LAUNCHES
    got = _reference(cfg, params, BeamConfig(**bc), enc, lens)
    _assert_same(got, want_mega)
    _assert_same(got, want_xla)
    _assert_same(beam.beam_decode(params, cfg, BeamConfig(**bc),
                                  torch.tensor(enc), torch.tensor(lens)),
                 want_xla)
    assert beam_mega.GRU_LAUNCHES == before


def test_gru_model_decodes_as_in_jax(tmp_path):
    """A -gru char + phone checkpoint written by JAX restores in the port
    and decodes as in JAX, greedy and by beam (both routes); the port's
    checkpoint of it restores in JAX to the same leaves."""
    cfg = gru_cfg()
    jparams, _ = init_both(cfg, 4)
    out = dict(jparams["decoder_char"]["output_proj"])
    out["bias"] = out["bias"].at[2].add(0.5)      # some rows finish early
    jparams["decoder_char"]["output_proj"] = out
    lm_cfg = LMConfig(vocab_size=cfg.decoders["char"].vocab_size)
    jpath = jckpt.save(str(tmp_path / "jax"), "asr.ckpt", 3,
                       jstep.create_state(jparams, cfg, lm_cfg))
    named, _ = checkpoint.restore_latest(str(tmp_path / "jax"))
    template = step.create_state(seq2seq.init(torch.Generator(), cfg,
                                              device="cpu"),
                                 cfg, lm_cfg, device="cpu")
    state = step.state_from_named(named, template)
    port_dir = str(tmp_path / "port")
    checkpoint.save(port_dir, "asr.ckpt", 3, step.state_to_named(state))
    back = jckpt.restore_latest(port_dir, jstep.create_state(jparams, cfg,
                                                             lm_cfg))[0]
    got, want = (jckpt.flatten_named(p) for p in (back.params, jparams))
    assert sorted(got) == sorted(want) and jpath
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], name)

    batch = make_batch(6)
    feats, lens = (jnp.asarray(batch["logmel"]),
                   jnp.asarray(batch["logmel_len"]))
    want = np.asarray(quick_jit(lambda p, f, n: jseq2seq.apply_greedy(
        p, cfg, f, n, task="char"), jparams, feats, lens)(jparams, feats,
                                                          lens))
    got = seq2seq.apply_greedy(state.params, cfg, torch.tensor(batch[
        "logmel"]), torch.tensor(batch["logmel_len"]))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 2).any()

    bc = dict(beam_size=3, max_steps=8)

    def jax_beam(p, f, n):
        states, _, enc_lens = jseq2seq.encode(p, cfg, f, n)
        return jbeam.beam_decode(p["decoder_char"], cfg.decoders["char"],
                                 JBeamConfig(**bc), states[2], enc_lens[2])
    want = quick_jit(jax_beam, jparams, feats, lens)(jparams, feats, lens)
    states, _, enc_lens = seq2seq.encode(state.params, cfg,
                                         torch.tensor(batch["logmel"]),
                                         torch.tensor(batch["logmel_len"]))
    dec = state.params["decoder_char"]
    for route in (beam.beam_decode, beam.beam_decode_steps):
        for rows in (slice(0, 2), slice(0, 3)):   # #15's B <= 2 and more
            _assert_same(route(dec, cfg.decoders["char"], BeamConfig(**bc),
                               states[2][rows], enc_lens[2][rows]),
                         [np.asarray(x)[rows] for x in want])


@pytest.mark.parametrize("k", [1, 4])
def test_cells_fused_gru_single_state(k):
    """A single GRU state (not a tuple) is taken and returned single, as
    in the reference, at N = 2k rows."""
    cfg, params, *_ = _both(np.random.default_rng(k), 1, use_lstm=False)
    rng = np.random.default_rng(k)
    N = 2 * k
    x, ctx, lm, h = (torch.tensor(rng.normal(size=(N, 8)).astype(np.float32))
                     for _ in range(4))
    lm_new, h_new, y = dec_step.cells_fused(params, x, ctx, lm, h,
                                            use_lstm=False)
    want = dec_step.cells_fused_reference(params, x, ctx, lm, (h,),
                                          use_lstm=False)
    assert torch.equal(lm_new, want[0]) and torch.equal(h_new, want[1][0])
    assert torch.equal(y, want[2]) and y.shape == (N, 8)


@pytest.mark.parametrize("decoder_type,use_lstm,raises", [
    ("rnn", False, False), ("transformer", False, True)])
def test_decoders_the_decode_takes(decoder_type, use_lstm, raises):
    """The greedy and beam entry points take GRU decoders; the transformer
    decoder still raises, naming its ROADMAP item."""
    cfg = gru_cfg()
    cfg = dataclasses.replace(cfg, decoders={
        t: dataclasses.replace(d, decoder_type=decoder_type,
                               use_lstm=use_lstm)
        for t, d in cfg.decoders.items()})
    checks = (lambda: beam.check_supported(cfg.decoders["char"],
                                           BeamConfig()),
              lambda: greedy.GreedyEvaluator(cfg, ["x"] * 9, "unused",
                                             device="cpu"))
    for check in checks:
        if raises:
            with pytest.raises(NotImplementedError,
                               match="Transformer family"):
                check()
        else:
            check()
