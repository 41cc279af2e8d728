"""Kernel #15's plain version, the beam route and beam evaluation of the
port on the CPU against the JAX package, on the same weights (the port's
init, carried to JAX by name):

- `beam_decode_mega_reference` against JAX's `beam_decode_mega` (the
  Pallas kernel in interpret mode) and JAX's XLA `beam_decode` (the oracle
  of tests/test_beam_megakernel.py): tokens up to the length and lengths
  exactly, scores within 1e-4 (sums of up to 8 float32 log-probs);
- `beam_decode` takes #15 at B <= 2 with k <= 16 and the per-step route
  otherwise;
- `BeamEvaluator` and `grid_search` write the JAX package's files and WER.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_tpu.config import BeamConfig as JBeamConfig
from e2e_asr_tpu.config import DecoderConfig as JDecoderConfig
from e2e_asr_tpu.core import checkpoint as jckpt
from e2e_asr_tpu.eval import beam as jbeam
from e2e_asr_tpu.eval import beam_eval as jbeam_eval
from e2e_asr_tpu.models import attn_decoder as jdec
from e2e_asr_tpu.ops import beam_megakernel as jmega
from e2e_asr_tpu.tools import beam_grid as jgrid
from e2e_asr_tpu_torch.config import BeamConfig, DecoderConfig
from e2e_asr_tpu_torch.core import checkpoint
from e2e_asr_tpu_torch.data import synth, text
from e2e_asr_tpu_torch.data.speech import SpeechDataset
from e2e_asr_tpu_torch.eval import beam, beam_eval
from e2e_asr_tpu_torch.kernels import beam_mega
from e2e_asr_tpu_torch.models import attn_decoder
from e2e_asr_tpu_torch.tools import beam_grid
from tests.test_e2e import small_model_cfg
from tests.test_torch_train_step import init_both, quick_jit

torch.set_num_threads(1)
DEC = dict(hidden_size_dec=8, emb_size=8, vocab_size=9, attention_vec_size=8,
           lm_hidden_size=8, samp_prob=0.0, out_prob_dec=1.0, max_output=8)


def _both(rng, B, *, eos_rig=False, **dec):
    """(port cfg, params, JAX cfg, params, enc [B,5,8], lens); with B > 1
    the last utterance is 2 frames shorter."""
    kw = {**DEC, **dec}
    cfg = DecoderConfig(**kw)
    params = attn_decoder.init(torch.Generator().manual_seed(3), cfg, 8,
                               device="cpu")
    if eos_rig:     # every hypothesis emits <eos> at its first step
        params["output_proj"]["kernel"].zero_()
        params["output_proj"]["bias"][text.EOS_ID] = 50.0
    jcfg = JDecoderConfig(**kw)
    shapes = jax.eval_shape(lambda: jdec.init(jax.random.PRNGKey(0), jcfg,
                                              attn_size=8))
    jparams = jax.tree_util.tree_map(jnp.asarray, jckpt.unflatten_named(
        shapes, checkpoint.named_from_params(params)))
    enc = rng.normal(size=(B, 5, 8)).astype(np.float32)
    lens = np.array([5] * (B - 1) + [5 if B == 1 else 3])
    return cfg, params, jcfg, jparams, enc, lens


def _reference(cfg, params, bc, enc, lens):
    ctx = attn_decoder.make_attn_context(params, torch.tensor(enc),
                                         torch.tensor(lens))
    return beam_mega.beam_decode_mega_reference(
        params, cfg, bc, ctx.enc_states, ctx.hidden_features, ctx.mask)


def _assert_same(got, want):
    (t0, l0, s0), (t1, l1, s1) = [[np.asarray(x) for x in o]
                                  for o in (got, want)]
    np.testing.assert_array_equal(l0, l1)
    for i in range(len(l0)):
        np.testing.assert_array_equal(t0[i, :l0[i]], t1[i, :l1[i]])
    np.testing.assert_allclose(s0, s1, rtol=1e-4, atol=1e-4)


def test_reference_matches_the_pallas_kernel(rng):
    cfg, params, jcfg, jparams, enc, lens = _both(rng, 1)
    bc = dict(beam_size=2, max_steps=5)
    want = jmega.beam_decode_mega(jparams, jcfg, JBeamConfig(**bc),
                                  jnp.asarray(enc), jnp.asarray(lens))
    _assert_same(_reference(cfg, params, BeamConfig(**bc), enc, lens), want)


CASES = {   # name: (B, beam options, decoder options)
    "base_b2_unequal": (2, {}, {}),
    "deep_simple_proj_penalty_k1_b2": (2, dict(word_ins_penalty=0.4,
                                               beam_size=1),
                                       dict(num_layers_dec=2,
                                            lm_hidden_size=12)),
    "eos_rigged_b1": (1, {}, dict(eos_rig=True)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_reference_and_route_match_the_xla_oracle(rng, name):
    B, beam_opts, dec = CASES[name]
    cfg, params, jcfg, jparams, enc, lens = _both(rng, B, **dec)
    bc = {**dict(beam_size=3, max_steps=8), **beam_opts}
    want = quick_jit(lambda p, e, n: jbeam.beam_decode(
        p, jcfg, JBeamConfig(**bc), e, n), jparams, jnp.asarray(enc),
        jnp.asarray(lens))(jparams, jnp.asarray(enc), jnp.asarray(lens))
    _assert_same(_reference(cfg, params, BeamConfig(**bc), enc, lens), want)
    _assert_same(beam.beam_decode(params, cfg, BeamConfig(**bc),
                                  torch.tensor(enc), torch.tensor(lens)),
                 want)
    if dec.get("eos_rig"):
        assert int(want[1][0]) == 1          # [<eos>] only


def test_route(rng, monkeypatch):
    """B <= 2 with k <= 16 takes #15 (the plain version on the CPU), B=3 or
    k=17 the per-step route; both give the same decode."""
    cfg, params, _, _, enc, lens = _both(rng, 3)
    enc, lens = torch.tensor(enc), torch.tensor(lens)
    taken = []
    for name in ("beam_decode_mega", "beam_decode_mega_reference"):
        fn = getattr(beam_mega, name)
        monkeypatch.setattr(beam_mega, name,
                            lambda *a, _f=fn, _n=name, **kw:
                            taken.append(_n) or _f(*a, **kw))
    steps = beam.beam_decode_steps
    monkeypatch.setattr(beam, "beam_decode_steps", lambda *a, **kw:
                        taken.append("steps") or steps(*a, **kw))
    for B, k, route in ((1, 4, "mega"), (2, 16, "mega"), (3, 4, "steps"),
                        (2, 17, "steps")):
        taken.clear()
        bc = BeamConfig(beam_size=k, max_steps=6)
        got = beam.beam_decode(params, cfg, bc, enc[:B], lens[:B])
        assert taken == (["steps"] if route == "steps" else
                         ["beam_decode_mega", "beam_decode_mega_reference"])
        _assert_same(got, steps(params, cfg, bc, enc[:B], lens[:B]))
    assert not beam.takes_mega({"embedding": torch.zeros(600, 8),
                                "dec_cells": [{}]}, BeamConfig(beam_size=16),
                               1)


@pytest.fixture(scope="module")
def dev_setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_beam_eval"))
    sizes = synth.make_vocab_dir(os.path.join(root, "vocab"))
    synth.write_speech_corpus(os.path.join(root, "dev.0001"), 2, seed=1,
                              feat_length=8, char_vocab=12, min_tokens=3,
                              max_tokens=6, frames_per_token=4)
    _, rev_vocab = text.initialize_vocabulary(
        os.path.join(root, "vocab", "char.vocab"))
    cfg = small_model_cfg(sizes["char"])
    jparams, named = init_both(cfg, 0)
    params = checkpoint.params_from_named(named, cfg, "cpu")
    ds = SpeechDataset([os.path.join(root, "dev.0001")], 2, 8,
                       is_training=False, tasks=("char",))
    return root, cfg, rev_vocab, jparams, params, ds


def _files(d):
    return {name: open(os.path.join(d, name), "rb").read()
            for name in sorted(os.listdir(d))
            if os.path.isfile(os.path.join(d, name))}


def test_beam_evaluator_and_grid_match_jax(dev_setup, monkeypatch, capsys):
    """Batches of 2 (#15's route in the port): the same WER, printed lines
    and files; a 2-point grid with its final test evaluation writes the
    same perf.txt, final_eval files and score.txt. JAX compiles one decoder
    per beam size (cov_penalty is a no-op in both packages)."""
    root, cfg, rev_vocab, jparams, params, ds = dev_setup
    compiled = {}
    make = jbeam_eval.make_beam_decoder

    def cached(model_cfg, beam_cfg, **kw):
        key = beam_cfg.beam_size
        if key not in compiled:
            compiled[key] = make(model_cfg, beam_cfg, **kw)
        return compiled[key]

    monkeypatch.setattr(jbeam_eval, "make_beam_decoder", cached)
    outs = {}
    for pkg, evaluator_cls, bc, p in (
            ("jax", jbeam_eval.BeamEvaluator, JBeamConfig, jparams),
            ("port", beam_eval.BeamEvaluator, BeamConfig, params)):
        kw = {} if pkg == "jax" else dict(device="cpu")
        out_dir = os.path.join(root, pkg, "eval")
        err = evaluator_cls(cfg, bc(beam_size=2), rev_vocab, out_dir,
                            **kw)(p, ds.epoch())
        printed = capsys.readouterr().out.replace(os.path.join(root, pkg),
                                                  "")
        grid_dir = os.path.join(root, pkg, "grid")
        grid = jgrid.grid_search if pkg == "jax" else beam_grid.grid_search
        best = grid(p, cfg, rev_vocab, ds.epoch, grid_dir, beam_sizes=(2,),
                    cov_penalties=(0.05, 0.1), test_batches_fn=ds.epoch,
                    **kw)
        outs[pkg] = (err, printed, _files(out_dir), _files(grid_dir),
                     _files(os.path.join(grid_dir, "final_eval")),
                     best[1], best[0].beam_size,
                     capsys.readouterr().out.replace(grid_dir, ""))
    assert outs["port"] == outs["jax"]
    assert set(outs["port"][2]) == {"gold.txt", "raw_2.txt"}
    assert "Score:" in outs["port"][1] and "Insertion:" in outs["port"][1]
    assert len(outs["port"][3]["perf.txt"].splitlines()) == 2
    assert "score.txt" in outs["port"][4]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        beam_grid.grid_search(params, cfg, rev_vocab, ds.epoch, root,
                              use_lm=True, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        beam_grid.grid_search(params, cfg, rev_vocab, ds.epoch, root,
                              ilm_weights=(0, 0.1), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        beam_eval.BeamEvaluator(cfg, BeamConfig(ctc_rescore=0.3), rev_vocab,
                                root, device="cpu")
