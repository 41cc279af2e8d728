"""Port parity for the training slice on the CPU: the loss, clip + Adam
and the whole ASR step of the port against the JAX package (the decoder's
training pass and kernel A's backward are in test_torch_train_kernels.py),
on the same weights (the port's init, carried across by name) and the same
noise (JAX's own, drawn from its keys and handed to the port).

The configuration is the recipe's at a small width: a 2-layer pyramidal
BiLSTM encoder (H=8), a 1-layer LSTM attention decoder for the characters
(V=9, L=6) on layer 2 and one for the phones (V=7, L=5) on layer 1, the
`avg` multitask loss, B=3, T=16 frames; dropout (keep 0.8 / 0.7) and
scheduled sampling (0.5) on.
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
from e2e_asr_tpu_torch.kernels import lstm_seq
from e2e_asr_tpu_torch.models import encoder, seq2seq
from e2e_asr_tpu_torch.train import step

torch.set_num_threads(1)
B, T, L, FEAT, V = 3, 16, 6, 6, 9
LP, VP = 5, 7                                   # the phone task


def train_cfg() -> Seq2SeqConfig:
    def dec(vocab):
        return DecoderConfig(hidden_size_dec=8, emb_size=8, vocab_size=vocab,
                             attention_vec_size=6, lm_hidden_size=8,
                             samp_prob=0.5, out_prob_dec=0.7, max_output=8)

    return Seq2SeqConfig(
        tasks=["char", "phone"], num_layers={"char": 2, "phone": 1},
        max_output={"char": 8, "phone": 8},
        encoder=EncoderConfig(hidden_size=8, out_prob=0.8),
        decoders={"char": dec(V), "phone": dec(VP)}, avg=True,
        feat_length=FEAT)


def make_batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    lens = np.array([T, 11, 5], np.int32)
    x = np.zeros((B, T, FEAT), np.float32)
    for i, n in enumerate(lens):
        x[i, :n] = rng.normal(size=(n, FEAT))
    batch = {"logmel": x, "logmel_len": lens}
    for task, steps, vocab, lengths in (("char", L, V, [L - 1, 3, 2]),
                                        ("phone", LP, VP, [LP - 1, 2, 3])):
        ids = np.zeros((B, steps), np.int32)
        ids[:, 0] = 1
        for i, n in enumerate(lengths):
            ids[i, 1:n] = rng.integers(3, vocab, size=n - 1)
            ids[i, n] = 2
        batch[task] = ids
        batch[f"{task}_len"] = np.array(lengths, np.int32)
    return batch


def draw_jax_noise(cfg, key, batch):
    """JAX's noise for apply_train(rng=key) (seq2seq.py:81, encoder.py:258,
    attn_decoder.py:235): the encoder's keep-masks and each task's decoder
    noise (traceable, so a test can draw it inside its jit)."""
    plan = encoder.layer_plan(cfg.encoder, max(cfg.num_layers.values()))
    rng_enc, rng_dec = jax.random.split(key)
    t, masks = batch["logmel"].shape[1], []
    for i, reduce in enumerate(plan):
        masks.append(jax.random.bernoulli(
            jax.random.fold_in(rng_enc, i + 1), cfg.encoder.out_prob,
            (t, B, 2 * cfg.encoder.hidden_size)))
        t = -(-t // cfg.encoder.skip_step) if reduce else t
    return masks, [jdec.train_noise(jax.random.fold_in(rng_dec, i),
                                    cfg.decoders[task],
                                    batch[task].shape[1] - 1, B)
                   for i, task in enumerate(cfg.tasks)]


def port_noise(cfg, drawn) -> dict:
    """draw_jax_noise's arrays as the port's noise dict."""
    masks, decoders = drawn
    to = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    noise = {"encoder": {i + 1: to(m) for i, m in enumerate(masks)}}
    for task, (flags, gumbel, lm_masks, inter) in zip(cfg.tasks, decoders):
        noise[task] = (to(flags), to(gumbel), to(lm_masks),
                       tuple(to(m) for m in inter))
    return noise


def init_both(cfg, seed: int):
    """Weights from the port's init for both packages: the JAX package's
    pytree (laid out by jax.eval_shape of its init, so nothing compiles)
    and the leaves by name."""
    named = checkpoint.named_from_params(seq2seq.init(
        torch.Generator().manual_seed(seed), cfg, device="cpu"))
    shapes = jax.eval_shape(lambda: jseq2seq.init(jax.random.PRNGKey(0),
                                                  cfg))
    jparams = jax.tree_util.tree_map(jnp.asarray,
                                     jckpt.unflatten_named(shapes, named))
    return jparams, named


def quick_jit(fn, *args):
    """fn compiled for these arguments with XLA's backend optimizations
    off: the same operations in float32 (results differ in the last bits at
    most, far inside the tolerances) for about half the compile time of a
    program these tests run a few times."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})


@pytest.fixture(scope="module")
def setup():
    """The config, its params for both packages (also by name) and JAX's
    jitted clip + Adam update, compiled once for the tests of this file."""
    cfg = train_cfg()
    jparams, named = init_both(cfg, 3)
    opt = jstep.make_optimizer(cfg.learning_rate, cfg.max_gradient_norm)
    jupdate = quick_jit(opt.update, jparams, opt.init(jparams), jparams)
    return cfg, jparams, named, jupdate


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
    """One asr_step of the char + phone model at small width, all noise on:
    the loss, both task losses and every gradient leaf (both decoders')
    against JAX's value_and_grad, and
    the params after the step where |g| is well above the tolerance (Adam's
    first update is about lr * sign(g)). The step's gradients are read from
    its new Adam state: after one unclipped step mu = (1 - b1) * g."""
    cfg, jparams, named, jupdate = setup
    batch = make_batch(5)
    key = jax.random.PRNGKey(7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    lm_cfg = LMConfig(vocab_size=V)
    jstate = jstep.create_state(jparams, cfg, lm_cfg)
    # JAX's asr_step (train/step.py:333), keeping the loss and grads, and
    # its noise, in one jit.
    ((jloss, jtasks), jgrads), drawn = quick_jit(lambda p: (
        jax.value_and_grad(
            lambda q: jseq2seq.apply_train(q, cfg, jbatch, rng=key),
            has_aux=True)(p),
        draw_jax_noise(cfg, key, jbatch)), jstate.params)(jstate.params)
    assert float(optax.global_norm(jgrads)) < cfg.max_gradient_norm
    updates, _ = jupdate(jgrads, jstate.opt_state, jstate.params)
    jnew = optax.apply_updates(jstate.params, updates)
    noise = port_noise(cfg, drawn)

    state = step.create_state(checkpoint.params_from_named(named, cfg, "cpu"),
                              cfg, lm_cfg, device="cpu")
    port_step, _ = step.make_train_step(cfg, lm_cfg, device="cpu")
    new_state, metrics = port_step(state, batch, None, noise=noise)
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                               rtol=1e-5)
    assert set(jtasks) == {"char", "phone"}
    for task, want in jtasks.items():
        np.testing.assert_allclose(float(metrics[f"loss_{task}"]),
                                   float(want), rtol=1e-5)
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
    x, w = torch.zeros(3, 2, 8), torch.zeros(2, 8)
    for kw in (dict(drop_keep=0.9), dict(bf16_matmul=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            lstm_seq.lstm_seq(x, w, **kw)
