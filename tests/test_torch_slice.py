"""Port parity for the whole serving slice on the CPU: the same weights in
both packages, carried across by name (the `setup` fixture, which
tests/test_torch_checkpoint.py shares), then the encoder, the beam decoder
and the batching engine of both packages on the same inputs.

Tolerances: encoder outputs 1e-5 absolute; beam tokens and lengths equal,
scores 1e-4 (sums of up to 16 float32 log-probs); transcripts equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_tpu.config import BeamConfig
from e2e_asr_tpu.core import checkpoint as jckpt
from e2e_asr_tpu.data import text
from e2e_asr_tpu.data.synth import make_vocab_dir
from e2e_asr_tpu.eval import beam_eval as jbeam_eval
from e2e_asr_tpu.eval import serving as jserving
from e2e_asr_tpu.models import seq2seq as jseq2seq
from e2e_asr_tpu_torch.core import checkpoint
from e2e_asr_tpu_torch.eval import beam_eval, serving
from e2e_asr_tpu_torch.models import seq2seq
from tests.test_e2e import small_model_cfg
from tests.test_torch_train_step import init_both

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_slice")
    sizes = make_vocab_dir(str(root / "vocab"))
    _, rev_vocab = text.initialize_vocabulary(
        str(root / "vocab" / "char.vocab"))
    cfg = small_model_cfg(sizes["char"])
    jparams, named = init_both(cfg, 0)
    return cfg, rev_vocab, jparams, named, root


def _feats(rng, T, feat=8):
    return rng.normal(size=(T, feat)).astype(np.float32)


def _batch(seed, lens, T=None, feat=8):
    rng = np.random.default_rng(seed)
    T = T or max(lens)
    x = np.zeros((len(lens), T, feat), np.float32)
    for i, n in enumerate(lens):
        x[i, :n] = _feats(rng, n, feat)
    return x, np.asarray(lens, np.int32)


def test_encode_matches_jax(setup):
    cfg, _, jparams, named, _ = setup
    params = checkpoint.params_from_named(named, cfg, "cpu")
    feats, lens = _batch(0, [29, 17, 8, 1], T=30)
    want = jseq2seq.encode(jparams, cfg, jnp.asarray(feats),
                           jnp.asarray(lens))
    got = seq2seq.encode(params, cfg, torch.tensor(feats), torch.tensor(lens))
    for depth in want[0]:
        np.testing.assert_allclose(got[0][depth].numpy(),
                                   np.asarray(want[0][depth]), atol=1e-5,
                                   rtol=0)
        np.testing.assert_array_equal(got[2][depth].numpy(),
                                      np.asarray(want[2][depth]))


@pytest.mark.parametrize("beam_size,penalty,eos_bias",
                         [(3, 0.0, 0.0), (2, 2.4, 0.1), (3, 0.5, 0.1)])
def test_beam_decoder_matches_jax(setup, beam_size, penalty, eos_bias):
    """Without an <eos> bias the random model never finishes (all live to
    max_steps); with one, hypotheses finish early and the finished buffer,
    the shrinking beam and the early exit take part."""
    cfg, _, jparams, named, _ = setup
    out = dict(jparams["decoder_char"]["output_proj"])
    out["bias"] = out["bias"].at[text.EOS_ID].add(eos_bias)
    jparams = {**jparams, "decoder_char": {**jparams["decoder_char"],
                                           "output_proj": out}}
    params = checkpoint.params_from_named(jckpt.flatten_named(jparams), cfg,
                                      "cpu")
    bc = BeamConfig(beam_size=beam_size, max_steps=16,
                    word_ins_penalty=penalty)
    feats, lens = _batch(1, [32, 21, 9, 14, 3])
    batch = {"logmel": feats, "logmel_len": lens}
    jt, jl, js = jbeam_eval.make_beam_decoder(cfg, bc)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tt, tl, ts = beam_eval.make_beam_decoder(cfg, bc)(params, batch)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert (tl.numpy() < bc.max_steps).all() == (eos_bias > 0)
    for b in range(len(lens)):
        np.testing.assert_array_equal(tt[b, :tl[b]].numpy(),
                                      np.asarray(jt[b, :jl[b]]))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4, rtol=0)


def test_serving_matches_jax_and_one_by_one(setup):
    """The port's engine gives JAX's engine's transcripts on the same
    requests, and batched output equals one-by-one output."""
    cfg, rev_vocab, jparams, named, _ = setup
    params = checkpoint.params_from_named(named, cfg, "cpu")
    rng = np.random.default_rng(2)
    feats = [_feats(rng, T) for T in [16, 40, 33, 60, 12, 64, 25]]
    kw = dict(beam_cfg=BeamConfig(beam_size=2, max_steps=16),
              bucket_frames=(32, 64))
    with jserving.BatchingTranscriber(jparams, cfg, rev_vocab, max_batch=4,
                                      max_wait_ms=50, **kw) as eng:
        want = [f.result(timeout=120) for f in [eng.submit(x) for x in feats]]
    with serving.BatchingTranscriber(params, cfg, rev_vocab, device="cpu",
                                     max_batch=4, max_wait_ms=50,
                                     **kw) as eng:
        got = [f.result(timeout=120) for f in [eng.submit(x) for x in feats]]
        assert eng.stats.requests == len(feats)
        assert eng.stats.batches < len(feats)
    with serving.BatchingTranscriber(params, cfg, rev_vocab, device="cpu",
                                     max_batch=1, max_wait_ms=1,
                                     **kw) as eng:
        single = [eng.transcribe(x) for x in feats]
    assert got == want
    assert single == got


def test_unported_features_raise(setup):
    cfg, rev_vocab, _, named, _ = setup
    params = checkpoint.params_from_named(named, cfg, "cpu")
    kw = dict(device="cpu", bucket_frames=(32,))
    for extra in (dict(with_confidence=True), dict(per_request_bias=1.0),
                  dict(mesh=object()), dict(lm_params={}),
                  dict(beam_cfg=BeamConfig(apply_cov_penalty=True,
                                           cov_penalty=0.5))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            serving.BatchingTranscriber(params, cfg, rev_vocab, **kw, **extra)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        beam_eval.make_beam_decoder(cfg, BeamConfig(), nbest=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        seq2seq.init(torch.Generator(),
                     dataclasses.replace(cfg, model_family="ctc"),
                     device="cpu")
