"""Port parity for the GRU family's training on the CPU:
- the `-gru` char + phone asr_step (GRU encoder, GRU decoders through
  kernels #6, #7 and #10's plain versions): the loss, both task losses,
  every gradient and the params after clip + Adam against JAX's
  value_and_grad and optax, on the same weights and JAX's own noise;
- the GRU leaf names (`.../gates/kernel`, `.../candidate/bias`, ...), and
  the optimizer slots', both ways: each package's checkpoint restores in
  the other;
- the port's Trainer for one epoch with a GRU encoder under the LSTM
  decoders (ASR and LM steps, greedy dev WER, a save), and with GRU
  decoders raising before its first step where its cadence would decode
  them or run the LM task on them.

The configuration is tests/test_torch_train_step.py's with GRU cells.
Tolerances (float32, sums in other orders): loss 1e-5 relative, gradients
1e-4 relative to each leaf's largest value, params after the step 1e-6.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from e2e_asr_tpu.config import LMConfig
from e2e_asr_tpu.core import checkpoint as jckpt
from e2e_asr_tpu.models import seq2seq as jseq2seq
from e2e_asr_tpu.train import step as jstep
from e2e_asr_tpu_torch.core import checkpoint
from e2e_asr_tpu_torch.data import synth
from e2e_asr_tpu_torch.models import seq2seq
from e2e_asr_tpu_torch.train import step
from e2e_asr_tpu_torch.train.loop import Trainer
from tests.test_torch_dec_train_gru import gru_cfg
from tests.test_torch_recipe import recipe_cfg, write_corpus
from tests.test_torch_train_step import (V, assert_leaves_close,
                                         draw_jax_noise, init_both,
                                         make_batch, port_noise, quick_jit)

torch.set_num_threads(1)


def test_gru_asr_step_matches_jax():
    """One char + phone asr_step of the GRU family, all noise on, against
    JAX's value_and_grad and optax's clip + Adam."""
    cfg = gru_cfg()
    lm_cfg = LMConfig(vocab_size=V)
    jparams, named = init_both(cfg, 3)
    batch = make_batch(5)
    key = jax.random.PRNGKey(7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jax_step(p):
        (loss, tasks), grads = jax.value_and_grad(
            lambda q: jseq2seq.apply_train(q, cfg, jbatch, rng=key),
            has_aux=True)(p)
        return loss, tasks, grads, draw_jax_noise(cfg, key, jbatch)

    jloss, jtasks, jgrads, drawn = quick_jit(jax_step, jparams)(jparams)
    jg = {k: np.asarray(v) for k, v in jckpt.flatten_named(jgrads).items()}
    flat_g = np.concatenate([np.ravel(v) for v in jg.values()])
    assert np.sqrt(np.sum(flat_g * flat_g)) < cfg.max_gradient_norm
    # optax's clip + Adam on every leaf at once (one flat leaf: the global
    # norm and the elementwise update are the same), one small jit; the
    # leaves are flattened in numpy, so nothing else compiles.
    flat = {"all": jnp.asarray(np.concatenate([
        np.ravel(np.asarray(named[k])) for k in jg]))}
    opt = jstep.make_optimizer(cfg.learning_rate, cfg.max_gradient_norm)
    new_flat = np.asarray(jax.jit(lambda p, g: optax.apply_updates(
        p, opt.update(g, opt.init(p), p)[0]))(
            flat, {"all": jnp.asarray(flat_g)})["all"])
    sizes = np.cumsum([0] + [v.size for v in jg.values()])
    jnew = {k: new_flat[a:b].reshape(v.shape) for (k, v), a, b in zip(
        jg.items(), sizes[:-1], sizes[1:])}

    state = step.create_state(checkpoint.params_from_named(named, cfg, "cpu"),
                              cfg, lm_cfg, device="cpu")
    port_step, _ = step.make_train_step(cfg, lm_cfg, device="cpu")
    new_state, metrics = port_step(state, batch, None,
                                   noise=port_noise(cfg, drawn))
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                               rtol=1e-5)
    for task, want in jtasks.items():
        np.testing.assert_allclose(float(metrics[f"loss_{task}"]),
                                   float(want), rtol=1e-5)
    mu = checkpoint.named_from_params(new_state.opt_state.mu)
    assert any("/candidate/kernel" in k for k in jg)
    assert_leaves_close({k: v / (1 - step.B1) for k, v in mu.items()}, jg)
    got = checkpoint.named_from_params(new_state.params)
    moved = 0
    for name, g in jg.items():
        big = np.abs(g) > max(1e-2 * np.abs(g).max(), 1e-6)
        moved += int(big.sum())
        np.testing.assert_allclose(got[name][big], jnew[name][big], rtol=0,
                                   atol=1e-6, err_msg=name)
    assert moved > 500


def test_gru_checkpoint_names_both_ways(tmp_path):
    """The GRU model's training state has the JAX TrainState's leaf names
    and shapes, optimizer slots included, and each package's checkpoint
    restores in the other."""
    cfg = gru_cfg()
    lm_cfg = LMConfig(vocab_size=V)
    jparams, named = init_both(cfg, 4)
    jstate = jax.jit(lambda p: jstep.create_state(p, cfg, lm_cfg)._replace(
        global_step=jnp.int32(3)))(jparams)
    jnamed = jckpt.flatten_named(jstate)
    assert "params/encoder/layer_1/bw/gates/kernel" in jnamed
    assert ("opt_state/1/inner_state/0/nu/decoder_phone/dec_cells/0/"
            "candidate/bias") in jnamed
    template = step.create_state(
        checkpoint.params_from_named(named, cfg, "cpu"), cfg, lm_cfg,
        device="cpu")
    assert {k: np.shape(v) for k, v in step.state_to_named(template).items()
            } == {k: np.shape(v) for k, v in jnamed.items()}
    jckpt.save(str(tmp_path / "jax"), "asr.ckpt", 3, jstate)
    state = step.state_from_named(
        checkpoint.restore_latest(str(tmp_path / "jax"))[0], template)
    back = step.state_to_named(state)
    for k, v in jnamed.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    path = checkpoint.save(str(tmp_path / "port"), "asr.ckpt", 3, back)
    restored = jckpt.flatten_named(jckpt.restore(path, jstate))
    for k, v in restored.items():
        np.testing.assert_array_equal(v, np.asarray(jnamed[k]), err_msg=k)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_gru"))
    return root, write_corpus(root, synth)


def _gru_recipe(root, sizes, decoders: bool, **train):
    cfg = recipe_cfg(root, sizes, **train)
    model = cfg.model
    model = dataclasses.replace(model, encoder=dataclasses.replace(
        model.encoder, use_lstm=False))
    if decoders:
        model = gru_cfg(model)
    return dataclasses.replace(cfg, model=model)


def test_trainer_gru_encoder_lstm_decoders(corpus, capsys):
    """One epoch of the Trainer with a GRU encoder under the LSTM
    decoders: ASR and LM steps, a cadence with greedy dev WER and a save."""
    root, sizes = corpus
    cfg = _gru_recipe(root, sizes, False, max_epochs=0,
                      train_dir=os.path.join(root, "train_mix"))
    state = Trainer(cfg, device="cpu").train()
    assert int(state.global_step) == 2 and int(state.lm_global_step) > 0
    named, _ = checkpoint.restore_latest(cfg.train.train_dir)
    assert int(named["global_step"]) == 2
    assert "params/encoder/layer_2/fw/candidate/kernel" in named
    assert "ASR error:" in capsys.readouterr().out


def test_trainer_with_gru_decoders_raises_before_the_first_step(corpus):
    """With GRU decoders the Trainer raises before any step where its
    cadence would decode them (greedy dev WER, slice 6) or run the LM task
    on the char decoder (the JAX package has no GRU LM task)."""
    root, sizes = corpus
    steps = []
    for kw, error, match in (
            ({}, NotImplementedError, "GRU decode"),
            ({"data_dir": os.path.join(root, "no_dev")}, ValueError,
             "GRU LM task")):
        cfg = _gru_recipe(root, sizes, True, **kw)
        trainer = Trainer(cfg, device="cpu")
        trainer.asr_step = trainer.lm_step = lambda *a, **k: steps.append(1)
        with pytest.raises(error, match=match):
            trainer.train()
    assert not steps
    _, lm_step = step.make_train_step(cfg.model, cfg.lm, device="cpu")
    params = seq2seq.init(torch.Generator().manual_seed(0), cfg.model,
                          device="cpu")
    state = step.create_state(params, cfg.model, cfg.lm, device="cpu")
    with pytest.raises(ValueError, match="GRU LM task"):
        lm_step(state, np.ones((4, 2), np.int64), np.array([3, 3]), None)
