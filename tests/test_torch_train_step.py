"""Port parity for the training slice on the CPU: the loss, clip + Adam
and the whole ASR step of the port against the JAX package (the decoder's
training pass and kernel A's backward are in test_torch_train_kernels.py),
on JAX-initialized weights carried across by name and the same noise (JAX's
own, rebuilt from its keys and handed to the port).

The configuration is the flagship's at a small width: a 2-layer pyramidal
BiLSTM encoder (H=8), a 1-layer LSTM attention decoder, V=9, B=3, T=16
frames, L=6; dropout (keep 0.8 / 0.7) and scheduled sampling (0.5) on.
Tolerances (float32, sums in other orders): loss 1e-5 relative, logits and
gradients 1e-4 relative to each leaf's largest value, optimizer 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from e2e_asr_tpu.config import (DecoderConfig, EncoderConfig, LMConfig,
                                Seq2SeqConfig)
from e2e_asr_tpu.core import checkpoint as jckpt
from e2e_asr_tpu.core import losses as jlosses
from e2e_asr_tpu.models import attn_decoder as jdec
from e2e_asr_tpu.models import seq2seq as jseq2seq
from e2e_asr_tpu.train import step as jstep
from e2e_asr_tpu_torch.core import checkpoint, losses
from e2e_asr_tpu_torch.models import encoder
from e2e_asr_tpu_torch.train import step

torch.set_num_threads(1)
B, T, L, FEAT, V = 3, 16, 6, 6, 9


def train_cfg(**dec) -> Seq2SeqConfig:
    return Seq2SeqConfig(
        tasks=["char"], num_layers={"char": 2}, max_output={"char": 8},
        encoder=EncoderConfig(hidden_size=8, out_prob=0.8),
        decoders={"char": DecoderConfig(**{
            **dict(hidden_size_dec=8, emb_size=8, vocab_size=V,
                   attention_vec_size=6, lm_hidden_size=8, samp_prob=0.5,
                   out_prob_dec=0.7, max_output=8), **dec})},
        feat_length=FEAT)


def make_batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    lens = np.array([T, 11, 5], np.int32)
    x = np.zeros((B, T, FEAT), np.float32)
    for i, n in enumerate(lens):
        x[i, :n] = rng.normal(size=(n, FEAT))
    char_len = np.array([L - 1, 3, 2], np.int32)
    char = np.zeros((B, L), np.int32)
    char[:, 0] = 1
    for i, n in enumerate(char_len):
        char[i, 1:n] = rng.integers(3, V, size=n - 1)
        char[i, n] = 2
    return {"logmel": x, "logmel_len": lens, "char": char,
            "char_len": char_len}


def jax_noise(cfg, key, batch) -> dict:
    """JAX's noise for apply_train(rng=key) (seq2seq.py:81, encoder.py:258,
    attn_decoder.py:235), as the port's noise dict."""
    plan = encoder.layer_plan(cfg.encoder, cfg.num_layers["char"])

    @jax.jit
    def draw(key):
        rng_enc, rng_dec = jax.random.split(key)
        t, masks = batch["logmel"].shape[1], []
        for i, reduce in enumerate(plan):
            masks.append(jax.random.bernoulli(
                jax.random.fold_in(rng_enc, i + 1), cfg.encoder.out_prob,
                (t, B, 2 * cfg.encoder.hidden_size)))
            t = -(-t // cfg.encoder.skip_step) if reduce else t
        return masks, jdec.train_noise(jax.random.fold_in(rng_dec, 0),
                                       cfg.decoders["char"], L - 1, B)

    masks, (flags, gumbel, lm_masks, inter) = draw(key)
    to = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    return {"encoder": {i + 1: to(m) for i, m in enumerate(masks)},
            "char": (to(flags), to(gumbel), to(lm_masks),
                     tuple(to(m) for m in inter))}


@pytest.fixture(scope="module")
def setup():
    """The config, JAX-initialized params (also by name) and JAX's jitted
    clip + Adam update, compiled once for the tests of this file."""
    cfg = train_cfg()
    jparams = jax.jit(lambda k: jseq2seq.init(k, cfg))(jax.random.PRNGKey(3))
    jupdate = jax.jit(jstep.make_optimizer(cfg.learning_rate,
                                           cfg.max_gradient_norm).update)
    return cfg, jparams, jckpt.flatten_named(jparams), jupdate


def assert_leaves_close(got: dict, want: dict, rel: float = 1e-4):
    assert sorted(got) == sorted(want)
    for name in want:
        w = np.asarray(want[name])
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(np.asarray(got[name]), w, rtol=0,
                                   atol=rel * scale, err_msg=name)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(5, 4, V)).astype(np.float32)
    targets = rng.integers(0, V, size=(5, 4)).astype(np.int32)
    lens = np.array([5, 3, 1, 0], np.int32)
    want = jlosses.cross_entropy_loss(jnp.asarray(logits),
                                      jnp.asarray(targets),
                                      jnp.asarray(lens), smoothing)
    got = losses.cross_entropy_loss(torch.tensor(logits),
                                    torch.tensor(targets), torch.tensor(lens),
                                    smoothing)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    t, m = losses.shifted_targets(torch.tensor(targets), torch.tensor(lens))
    jt, jm = jlosses.shifted_targets(jnp.asarray(targets), jnp.asarray(lens))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))


def test_optimizer_matches_optax(setup):
    """Three clip + Adam steps from numpy gradients: the second is clipped
    (norm above 5.0) and the third runs after set_lr."""
    cfg, jparams, named, jupdate = setup
    lm_cfg = LMConfig(vocab_size=V)
    jstate = jstep.create_state(jparams, cfg, lm_cfg)
    state = step.create_state(checkpoint.params_from_named(named, cfg, "cpu"),
                              cfg, lm_cfg, device="cpu")
    port_opt = step.make_optimizer(cfg.learning_rate, cfg.max_gradient_norm)
    rng = np.random.default_rng(1)
    for i, scale in enumerate([0.01, 10.0, 0.02]):
        if i == 2:
            jstate = jstep.set_lr(jstate, 3e-4)
            state = step.set_lr(state, 3e-4)
            assert step.get_lr(state) == pytest.approx(3e-4)
        g = {k: (rng.normal(size=v.shape) * scale).astype(np.float32)
             for k, v in named.items()}
        jg = jax.tree_util.tree_map(jnp.asarray,
                                    jckpt.unflatten_named(jparams, g))
        updates, new_opt = jupdate(jg, jstate.opt_state, jstate.params)
        jstate = jstate._replace(params=optax.apply_updates(jstate.params,
                                                            updates),
                                 opt_state=new_opt)
        grads = checkpoint.params_from_named(g, cfg, "cpu")
        params, opt_state = port_opt.update(grads, state.opt_state,
                                            state.params)
        state = state._replace(params=params, opt_state=opt_state)
        norm = np.sqrt(sum(float((x * x).sum()) for x in g.values()))
        assert (norm > cfg.max_gradient_norm) == (i == 1)
    got = checkpoint.named_from_params(state.params)
    want = jckpt.flatten_named(jstate.params)
    for name in want:
        np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                   rtol=0, atol=1e-6, err_msg=name)
    assert int(state.opt_state.count) == 3


def test_asr_step_matches_jax(setup):
    """One asr_step on the flagship configuration at small width, all noise
    on: the loss and every gradient leaf against JAX's value_and_grad, and
    the params after the step where |g| is well above the tolerance (Adam's
    first update is about lr * sign(g)). The step's gradients are read from
    its new Adam state: after one unclipped step mu = (1 - b1) * g."""
    cfg, jparams, named, jupdate = setup
    batch = make_batch(5)
    key = jax.random.PRNGKey(7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    lm_cfg = LMConfig(vocab_size=V)
    jstate = jstep.create_state(jparams, cfg, lm_cfg)
    # JAX's asr_step (train/step.py:333), keeping the loss and grads.
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jseq2seq.apply_train(p, cfg, jbatch, rng=key),
        has_aux=True))(jstate.params)
    assert float(optax.global_norm(jgrads)) < cfg.max_gradient_norm
    updates, _ = jupdate(jgrads, jstate.opt_state, jstate.params)
    jnew = optax.apply_updates(jstate.params, updates)
    noise = jax_noise(cfg, key, batch)

    state = step.create_state(checkpoint.params_from_named(named, cfg, "cpu"),
                              cfg, lm_cfg, device="cpu")
    port_step, _ = step.make_train_step(cfg, lm_cfg, device="cpu")
    new_state, metrics = port_step(state, batch, None, noise=noise)
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                               rtol=1e-5)
    mu = checkpoint.named_from_params(new_state.opt_state.mu)
    grads = {k: v / (1 - step.B1) for k, v in mu.items()}
    jg = jckpt.flatten_named(jgrads)
    assert_leaves_close(grads, jg)
    assert int(new_state.global_step) == 1
    got = checkpoint.named_from_params(new_state.params)
    want = jckpt.flatten_named(jnew)
    moved = 0
    for name, g in jg.items():
        # 100x the gradient tolerance and far above Adam's eps.
        big = np.abs(g) > max(1e-2 * np.abs(g).max(), 1e-6)
        moved += int(big.sum())
        np.testing.assert_allclose(got[name][big], np.asarray(want[name])[big],
                                   rtol=0, atol=1e-6, err_msg=name)
    assert moved > 500


def test_unported_options_raise(setup):
    cfg = setup[0]
    lm_cfg = LMConfig()
    for kw in (dict(grad_accum=2), dict(ema_decay=0.9), dict(spec_augment=True),
               dict(freeze=("encoder",)), dict(skip_nonfinite=True),
               dict(compute_dtype="bfloat16"), dict(pp_mesh=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            step.make_train_step(cfg, lm_cfg, device="cpu", **kw)
    for bad in (dataclasses.replace(cfg, model_family="ctc"),
                dataclasses.replace(cfg, ctc_weight=0.3),
                dataclasses.replace(cfg, encoder=dataclasses.replace(
                    cfg.encoder, remat=True))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            step.make_train_step(bad, lm_cfg, device="cpu")
    _, lm_step = step.make_train_step(cfg, lm_cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lm_step(None, None, None, None)
