"""Port parity for the LM task on the CPU: the weight-tied RNN-LM's loss and
the LM step (autograd through kernel #3's and #5's plain versions, clip +
Adam with the LM's own state) against the JAX package's rnn_lm.loss and
jitted lm_step over three steps, on the same weights and JAX's own dropout
masks (rebuilt from its keys); the training state under the JAX package's
checkpoint names; the checkpoint GC rule.

The configuration is the flagship's at a small width (as
tests/test_torch_train_step.py), the LM batch B=4 of up to 9 tokens with a
padded tail row (valid 0), dropout keep 0.8.
Tolerances (float32, sums in other orders): loss 1e-5 relative, gradients
1e-4 relative to each leaf's largest value, params and Adam slots after
three steps 1e-6 absolute; the leaves the LM does not share keep their
bits exactly.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_tpu.config import LMConfig
from e2e_asr_tpu.core import checkpoint as jckpt
from e2e_asr_tpu.models import rnn_lm as jrnn_lm
from e2e_asr_tpu.train import step as jstep
from e2e_asr_tpu_torch.core import checkpoint
from e2e_asr_tpu_torch.models import rnn_lm
from e2e_asr_tpu_torch.train import step
from tests.test_torch_train_step import (V, assert_leaves_close, init_both,
                                         quick_jit, train_cfg)

torch.set_num_threads(1)
B, T_LM = 4, 9
TIED = ("decoder_char/lm_cell/", "decoder_char/output_proj/",
        "decoder_char/embedding")


@pytest.fixture(scope="module")
def lm_setup():
    cfg = train_cfg()
    lm_cfg = LMConfig(lm_batch_size=B, out_prob=0.8, vocab_size=V,
                      lm_hidden_size=8, emb_size=8)
    jparams, named = init_both(cfg, 3)
    return cfg, lm_cfg, jparams, named


def lm_batch(seed):
    """[T, B] ids from <go>, seq_len counting the shifted targets, the last
    row padding (valid 0, length 1) as data/lm.py pads a tail batch."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((T_LM, B), np.int32)
    lens = np.array([T_LM - 1, 5, 3, 1], np.int32)
    for b, n in enumerate(lens[:3]):
        ids[0, b] = 1
        ids[1:n, b] = rng.integers(3, V, size=n - 1)
        ids[n, b] = 2
    return ids, lens, np.array([1, 1, 1, 0], np.float32)


def jax_mask(key, lm_cfg):
    return torch.tensor(np.asarray(jax.random.bernoulli(
        key, lm_cfg.out_prob, (T_LM - 1, B, lm_cfg.lm_hidden_size))))


def test_lm_loss_matches_jax(lm_setup):
    """Without and with dropout, a padded row in the batch."""
    cfg, lm_cfg, jparams, named = lm_setup
    params = checkpoint.params_from_named(named, cfg, "cpu")
    ids, lens, valid = lm_batch(0)
    key = jax.random.PRNGKey(9)
    wants = quick_jit(lambda p: [jrnn_lm.loss(
        p, lm_cfg, jnp.asarray(ids), jnp.asarray(lens), train=train,
        rng=key, valid=jnp.asarray(valid)) for train in (False, True)],
        jparams)(jparams)
    for train, want in zip((False, True), wants):
        got = rnn_lm.loss(params, lm_cfg, torch.tensor(ids),
                          torch.tensor(lens), train=train,
                          noise=jax_mask(key, lm_cfg),
                          valid=torch.tensor(valid))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    shared = rnn_lm.shared_lm_params(params)
    assert shared["lstm"] is params["decoder_char"]["lm_cell"]
    assert shared["embedding"] is params["decoder_char"]["embedding"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rnn_lm.shared_lm_params({"decoder_char": {"blocks": []}})


def test_lm_step_matches_jax_over_three_steps(lm_setup):
    """Three LM steps from the same weights: the loss of each, the
    gradients of the first (JAX's read back from its Adam state: after one
    unclipped step mu = (1 - b1) * g), then the params and both Adam slots
    after the third; the ASR optimizer state and every untied leaf stay as
    they were."""
    cfg, lm_cfg, jparams, named = lm_setup
    jstate = jstep.create_state(jparams, cfg, lm_cfg)
    _, jlm_step = jstep.make_train_step(cfg, lm_cfg)
    ids, lens, valid = map(jnp.asarray, lm_batch(10))
    jlm_step = quick_jit(jlm_step, jstate, ids, lens, jax.random.PRNGKey(0),
                         valid)
    state = step.create_state(checkpoint.params_from_named(named, cfg, "cpu"),
                              cfg, lm_cfg, device="cpu")
    before = checkpoint.named_from_params(state.params)
    _, lm_step = step.make_train_step(cfg, lm_cfg, device="cpu")
    for i in range(3):
        ids, lens, valid = lm_batch(10 + i)
        key = jax.random.PRNGKey(20 + i)
        if i == 0:
            _, grads = lm_step.loss_and_grads(state.params, ids, lens, None,
                                              valid, jax_mask(key, lm_cfg))
            grads = checkpoint.named_from_params(grads)
            norm = np.sqrt(sum(float((g * g).sum()) for g in grads.values()))
            assert norm < lm_cfg.max_gradient_norm
        jstate, jmetrics = jlm_step(jstate, jnp.asarray(ids),
                                    jnp.asarray(lens), key,
                                    jnp.asarray(valid))
        state, metrics = lm_step(state, ids, lens, None, valid,
                                 noise=jax_mask(key, lm_cfg))
        np.testing.assert_allclose(float(metrics["lm_loss"]),
                                   float(jmetrics["lm_loss"]), rtol=1e-5)
        if i == 0:
            head = "lm_opt_state/1/inner_state/0/mu/"
            assert_leaves_close(grads, {
                k[len(head):]: np.asarray(v) / (1 - step.B1)
                for k, v in jckpt.flatten_named(jstate).items()
                if k.startswith(head)})
    assert (int(state.lm_global_step), int(state.global_step)) == (3, 0)
    assert int(state.lm_opt_state.count) == 3
    assert int(state.opt_state.count) == 0
    got = step.state_to_named(state)
    want = jckpt.flatten_named(jstate)
    for name in ("params", "lm_opt_state/1/inner_state/0/mu",
                 "lm_opt_state/1/inner_state/0/nu"):
        leaves = [k for k in want if k.startswith(name + "/")]
        assert leaves
        for k in leaves:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                       atol=1e-6, err_msg=k)
    after = checkpoint.named_from_params(state.params)
    moved = set()
    for name, leaf in before.items():
        if any(name.startswith(t) for t in TIED):
            moved.add(name)
            assert not np.array_equal(after[name], leaf), name
        else:
            assert np.array_equal(after[name], leaf), name
    assert len(moved) == 5


def test_state_names_match_jax_checkpoints(lm_setup, tmp_path):
    """The port's state has the JAX TrainState's leaf names and shapes, and
    each package's checkpoint restores in the other."""
    cfg, lm_cfg, jparams, named = lm_setup
    jstate = jstep.create_state(jparams, cfg, lm_cfg)
    jstate = jstep.set_lr(jstate, 2.5e-4)._replace(
        global_step=jnp.int32(7), lm_epoch=jnp.int32(2))
    jnamed = jckpt.flatten_named(jstate)
    template = step.create_state(
        checkpoint.params_from_named(named, cfg, "cpu"), cfg, lm_cfg,
        device="cpu")
    port_named = step.state_to_named(template)
    assert {k: np.shape(v) for k, v in port_named.items()} == {
        k: np.shape(v) for k, v in jnamed.items()}
    path = jckpt.save(str(tmp_path / "jax"), "asr.ckpt", 7, jstate)
    named, meta = checkpoint.restore_latest(str(tmp_path / "jax"))
    state = step.state_from_named(named, template)
    assert step.get_lr(state) == pytest.approx(2.5e-4)
    assert (int(state.global_step), int(state.lm_epoch)) == (7, 2)
    back = step.state_to_named(state)
    for k, v in jnamed.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    port_path = checkpoint.save(str(tmp_path / "port"), "asr.ckpt", 7, back,
                                meta={"best": 0.5})
    restored = jckpt.restore(port_path, jstate)
    for k, v in jckpt.flatten_named(restored).items():
        np.testing.assert_array_equal(v, np.asarray(jnamed[k]), err_msg=k)
    assert jckpt.latest_path(str(tmp_path / "port"))[1] == {"best": 0.5}
    assert path.endswith("asr.ckpt-7.npz")


def test_gc_keeps_the_newest_committed_steps(tmp_path):
    """max_to_keep=2 keeps the two newest steps up to the pointer's and
    never deletes a newer step that a writer may be publishing."""
    d = tmp_path / "ckpt"
    leaf = {"x": np.zeros(2, np.float32)}
    for s in (1, 2, 3):
        checkpoint.save(str(d), "asr.ckpt", s, leaf)
    np.savez(str(d / "asr.ckpt-9.npz"), **leaf)        # not yet published
    checkpoint.save(str(d), "asr.ckpt", 4, leaf, max_to_keep=2)
    assert sorted(p.name for p in d.glob("*.npz")) == [
        "asr.ckpt-3.npz", "asr.ckpt-4.npz", "asr.ckpt-9.npz"]
    assert json.loads((d / "checkpoint").read_text())["step"] == 4
    assert checkpoint.latest_path(str(d))[0].endswith("asr.ckpt-4.npz")
