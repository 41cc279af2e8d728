"""Port parity for the transducer (RNN-T) family on the CPU, against the
JAX package on the same weights (the port's init, carried across by name)
and the same noise (JAX's own, drawn from its keys and handed to the
port):

- init: the leaf names and shapes both ways, params_from_named (strict),
  named_from_params and the training state's names;
- the model loss and every gradient against JAX's `transducer.loss`
  (encoder and prediction-network dropout on), and the chunked joint
  against the unchunked one;
- one `asr_step` against JAX's value_and_grad and optax;
- greedy decode and beam search (k=2) from encoder states against JAX's
  `greedy_decode_states` and `transducer_beam_decode`;
- `TransducerEvaluator`'s files and WER against the JAX evaluator's on
  the port's tokens; a serving burst; the command line's transducer
  branch (train, -dev greedy and beam, -test).

The configuration is small: a 2-layer pyramidal BiLSTM encoder (H=8), a
2-layer prediction network (8 wide), joint 12, V=9, B=3, T=16 frames.
Each JAX function compiles once, in a module-scoped fixture. Tolerances
(float32, sums in other orders): loss 1e-5 relative, gradients 1e-4 of
each leaf's largest value, params after the step 1e-6 where the gradient
is well above that (the attention step test's), beam scores 1e-4; tokens
exactly.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from e2e_asr_tpu.config import (DecoderConfig, EncoderConfig, LMConfig,
                                Seq2SeqConfig)
from e2e_asr_tpu.core import checkpoint as jckpt
from e2e_asr_tpu.eval import greedy as jgreedy
from e2e_asr_tpu.eval import transducer_beam as jbeam
from e2e_asr_tpu.models import transducer as jtransducer
from e2e_asr_tpu.train import step as jstep
from e2e_asr_tpu_torch.cli import main
from e2e_asr_tpu_torch.config import BeamConfig
from e2e_asr_tpu_torch.core import checkpoint
from e2e_asr_tpu_torch.core import transducer_loss as tloss
from e2e_asr_tpu_torch.core.cells import lstm_zero_state
from e2e_asr_tpu_torch.data import synth
from e2e_asr_tpu_torch.eval import greedy, serving, transducer_beam
from e2e_asr_tpu_torch.models import encoder, seq2seq, transducer
from e2e_asr_tpu_torch.train import step

torch.set_num_threads(1)
B, T, L, FEAT, V = 3, 16, 6, 6, 9
REV_VOCAB = ["<pad>", "<go>", "<eos>", " ", "a", "b", "c", "d", "e"]


def rnnt_cfg() -> Seq2SeqConfig:
    cfg = Seq2SeqConfig(tasks=["char"], num_layers={"char": 2},
                        max_output={"char": 10},
                        encoder=EncoderConfig(hidden_size=8, out_prob=0.8),
                        feat_length=FEAT, model_family="transducer")
    cfg.decoders["char"] = DecoderConfig(
        hidden_size_dec=8, emb_size=8, vocab_size=V, joint_dim=12,
        num_layers_dec=2, out_prob_dec=0.7, max_output=10)
    return cfg


def make_batch(seed: int) -> dict:
    """Features and <go> ... <eos> char ids, ragged in both lengths."""
    rng = np.random.default_rng(seed)
    lens = np.array([T, 11, 5], np.int32)
    x = np.zeros((B, T, FEAT), np.float32)
    for i, n in enumerate(lens):
        x[i, :n] = rng.normal(size=(n, FEAT))
    char_len = np.array([L - 1, 3, 1], np.int32)
    ids = np.zeros((B, L), np.int32)
    ids[:, 0] = 1
    for i, n in enumerate(char_len):
        ids[i, 1:n] = rng.integers(3, V, size=n - 1)
        ids[i, n] = 2
    return {"logmel": x, "logmel_len": lens, "char": ids,
            "char_len": char_len}


def draw_jax_noise(cfg, key, batch):
    """JAX's noise for transducer.loss(rng=key) (models/transducer.py:179,
    :92; encoder.py:258): the encoder's keep-masks by depth and the
    prediction network's per layer (traceable)."""
    rng_enc, rng_pred = jax.random.split(key)
    plan = encoder.layer_plan(cfg.encoder, 2)
    t, masks = T, []
    for i, reduce in enumerate(plan):
        masks.append(jax.random.bernoulli(
            jax.random.fold_in(rng_enc, i + 1), cfg.encoder.out_prob,
            (t, B, 2 * cfg.encoder.hidden_size)))
        t = -(-t // cfg.encoder.skip_step) if reduce else t
    dec, pred = cfg.decoders["char"], []
    for _ in range(dec.num_layers_dec):
        rng_pred, k = jax.random.split(rng_pred)
        pred.append(jax.random.bernoulli(k, dec.out_prob_dec,
                                         (L, B, dec.emb_size)))
    return masks, pred


def port_noise(drawn) -> dict:
    masks, pred = drawn
    to = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    return {"encoder": {i + 1: to(m) for i, m in enumerate(masks)},
            "pred": [to(m) for m in pred]}


def quick_jit(fn, *args):
    """fn compiled for these arguments with XLA's backend optimizations
    off (the same float32 operations) for about half the compile time."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})


def assert_leaves_close(got: dict, want: dict, rel: float = 1e-4):
    assert sorted(got) == sorted(want)
    for name in want:
        w = np.asarray(want[name])
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(np.asarray(got[name]), w, rtol=0,
                                   atol=rel * scale, err_msg=name)


@pytest.fixture(scope="module")
def setup():
    """The config; the port's init by name and as JAX's pytree (laid out
    by jax.eval_shape, so no init compiles); one JAX training loss, its
    gradients and its noise, in one compile."""
    cfg = rnnt_cfg()
    named = checkpoint.named_from_params(transducer.init(
        torch.Generator().manual_seed(3), cfg, V, device="cpu"))
    shapes = jax.eval_shape(lambda: jtransducer.init(jax.random.PRNGKey(0),
                                                     cfg, V))
    jparams = jax.tree_util.tree_map(jnp.asarray,
                                     jckpt.unflatten_named(shapes, named))
    batch = make_batch(5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(7)

    def loss_fn(p):
        tb = dict(jbatch)
        tb["labels"], tb["label_lens"] = jstep._ctc_labels(jbatch)
        return jtransducer.loss(p, cfg, tb, rng=key)

    (jloss, jgrads), drawn = quick_jit(lambda p: (
        jax.value_and_grad(loss_fn)(p), draw_jax_noise(cfg, key, jbatch)),
        jparams)(jparams)
    return cfg, shapes, jparams, named, batch, (jloss, jgrads, drawn)


def test_init_names_both_ways(setup):
    cfg, shapes, _, named, _, _ = setup
    want = {k: v.shape for k, v in jckpt.flatten_named(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape), shapes)).items()}
    assert {k: v.shape for k, v in named.items()} == want
    assert {"pred/embedding", "pred/layer_1/kernel", "joint/out/bias",
            "joint/enc_proj/kernel", "encoder/layer_2/bw/kernel"} <= set(want)
    params = checkpoint.params_from_named(named, cfg, device="cpu")
    back = checkpoint.named_from_params(params)
    assert all(np.array_equal(back[k], v) for k, v in named.items())
    with pytest.raises(ValueError, match="missing"):
        checkpoint.params_from_named(
            {k: v for k, v in named.items() if k != "joint/out/bias"}, cfg,
            device="cpu")
    state = step.create_state(params, cfg, LMConfig(), device="cpu")
    state_named = step.state_to_named(state)
    assert "params/pred/layer_0/kernel" in state_named
    assert "opt_state/1/inner_state/0/mu/joint/pred_proj/kernel" in \
        state_named
    again = step.state_to_named(step.state_from_named(state_named, state))
    assert all(np.array_equal(again[k], v) for k, v in state_named.items())


def test_model_loss_and_gradients_match_jax(setup):
    cfg, _, _, named, batch, (jloss, jgrads, drawn) = setup
    leaves = {k: torch.tensor(v, requires_grad=True)
              for k, v in named.items()}
    params = checkpoint._fill(checkpoint.params_from_named(
        named, cfg, device="cpu"), leaves)
    labels, label_lens = step._ctc_labels(
        {k: torch.tensor(v).long() for k, v in batch.items()
         if k.startswith("char")})
    tb = {"logmel": torch.tensor(batch["logmel"]),
          "logmel_len": torch.tensor(batch["logmel_len"]),
          "labels": labels, "label_lens": label_lens}
    loss = transducer.loss(params, cfg, tb, train=True,
                           noise=port_noise(drawn))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    assert_leaves_close({k: g.numpy() for k, g in zip(leaves, grads)},
                        jckpt.flatten_named(jgrads))
    # The joint in chunks of 3 frames (recomputed in the backward) gives
    # the unchunked lattices and gradients.
    enc = torch.randn(B, 7, 16, generator=torch.Generator().manual_seed(1))
    pred = torch.randn(B, L, 8, generator=torch.Generator().manual_seed(2),
                       requires_grad=True)
    runs = []
    for t_chunk in (None, 3):
        lat = transducer.lattice_logprobs(params, labels, enc, pred,
                                          t_chunk=t_chunk)
        runs.append((*lat, *torch.autograd.grad(
            sum((x * x).sum() for x in lat),
            [pred, leaves["joint/out/kernel"]])))
    for a, b in zip(*runs):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_asr_step_matches_jax_and_optax(setup):
    """One transducer asr_step: the loss, the per-task loss and every
    gradient of its loss_and_grads, and the params after clip (the
    gradients' norm is above 5.0 here) + Adam against optax."""
    cfg, _, jparams, named, batch, (jloss, jgrads, drawn) = setup
    opt = jstep.make_optimizer(cfg.learning_rate, cfg.max_gradient_norm)
    updates, _ = quick_jit(opt.update, jgrads, opt.init(jparams), jparams)(
        jgrads, opt.init(jparams), jparams)
    jnew = jckpt.flatten_named(jax.tree_util.tree_map(
        lambda p, u: p + u, jparams, updates))
    lm_cfg = LMConfig()
    state = step.create_state(checkpoint.params_from_named(named, cfg, "cpu"),
                              cfg, lm_cfg, device="cpu")
    asr_step, _ = step.make_train_step(cfg, lm_cfg, device="cpu")
    _, _, grads = asr_step.loss_and_grads(state.params, batch, None,
                                          port_noise(drawn))
    new_state, metrics = asr_step(state, batch, None, port_noise(drawn))
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                               rtol=1e-5)
    assert float(metrics["loss_transducer"]) == float(metrics["loss"])
    jg = jckpt.flatten_named(jgrads)
    assert_leaves_close(checkpoint.named_from_params(grads), jg)
    assert float(optax.global_norm(jgrads)) > cfg.max_gradient_norm
    got = checkpoint.named_from_params(new_state.params)
    moved = 0
    for name, g in jg.items():
        big = np.abs(g) > max(1e-2 * np.abs(g).max(), 1e-6)
        moved += int(big.sum())
        np.testing.assert_allclose(got[name][big], np.asarray(jnew[name])[big],
                                   rtol=0, atol=1e-6, err_msg=name)
    assert moved > 500 and int(new_state.global_step) == 1


def test_greedy_and_beam_decode_match_jax(setup):
    """From random encoder states (ragged lengths, one of 0 frames): the
    greedy tokens and emission frames, the greedy state carry across two
    chunks, and the beam search's tokens, lengths and scores at k=2."""
    cfg, _, jparams, named, _, _ = setup
    rng = np.random.default_rng(6)
    enc = (rng.normal(size=(4, 9, 16)) * 2.0).astype(np.float32)
    lens = np.array([9, 6, 0, 3], np.int32)

    def decode(p, e, n):
        tokens, frames = jtransducer.greedy_decode_states(
            p, cfg, e, n, return_frames=True)
        return tokens, frames, jbeam.transducer_beam_decode(
            p, cfg, e, n, beam_size=2)

    want_tok, want_frames, want_beam = quick_jit(decode, jparams, enc, lens)(
        jparams, enc, lens)
    params = checkpoint.params_from_named(named, cfg, device="cpu")
    e, n = torch.tensor(enc), torch.tensor(lens)
    tokens, frames = transducer.greedy_decode_states(params, cfg, e, n,
                                                     return_frames=True)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(frames.numpy(), np.asarray(want_frames))
    assert (tokens.numpy() != 0).sum() > 5
    # Streaming: two chunks with the state carried equal one pass (rows
    # with all their frames in the first chunk stop there), with room for
    # every emission.
    cap = {"max_output": 64}
    whole = transducer.greedy_decode_states(params, cfg, e, n, **cap)
    first, state = transducer.greedy_decode_states(
        params, cfg, e[:, :5], n.clamp(max=5), return_state=True, **cap)
    second = transducer.greedy_decode_states(
        params, cfg, e[:, 5:], (n - 5).clamp(min=0), init_state=state, **cap)
    joined = [list(a[a != 0]) + list(b[b != 0]) for a, b in
              zip(first.numpy(), second.numpy())]
    assert joined == [list(r[r != 0]) for r in whole.numpy()]
    seqs, blens, scores = transducer_beam.transducer_beam_decode(
        params, cfg, e, n, beam_size=2)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(want_beam[0]))
    np.testing.assert_array_equal(blens.numpy(), np.asarray(want_beam[1]))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_beam[2]),
                               rtol=1e-4, atol=1e-4)


def eval_batches(seed: int) -> list[dict]:
    """Two dataset-like batches of 2 with a padded tail row."""
    out = []
    for i in range(2):
        b = make_batch(seed + i)
        out.append({"logmel": b["logmel"][:2], "logmel_len":
                    b["logmel_len"][:2], "char": b["char"][:2],
                    "valid": np.array([True, i == 0]),
                    "utt_ids": [f"u{i}a", f"u{i}b"]})
    return out


def test_evaluator_files_and_wer_match_jax(setup, tmp_path):
    """The port's TransducerEvaluator, greedy and at beam 2, against the
    JAX evaluator's scoring and files on the port's own tokens (its decode
    is stubbed, so nothing compiles); the tokens are held to JAX's decodes
    in test_greedy_and_beam_decode_match_jax."""
    cfg, _, _, named, _, _ = setup
    params = checkpoint.params_from_named(named, cfg, device="cpu")
    batches = eval_batches(11)
    for k in (1, 2):
        port_dir, jax_dir = tmp_path / f"port{k}", tmp_path / f"jax{k}"
        evaluator = greedy.TransducerEvaluator(
            cfg, REV_VOCAB, str(port_dir), beam_size=k, device="cpu")
        tokens = []
        real = evaluator._decode
        evaluator._decode = lambda p, f, n: tokens.append(real(p, f, n)) or \
            tokens[-1]
        wer = evaluator(params, batches)
        jev = jgreedy.TransducerEvaluator(cfg, REV_VOCAB, str(jax_dir),
                                          beam_size=k)
        feed = iter(tokens)
        jev._decode = lambda **kw: next(feed).numpy()
        assert wer == jev(None, batches)
        for kind in ("gold", "raw", "decoded"):
            name = f"{kind}_asr.txt"
            assert (port_dir / name).read_text() == \
                (jax_dir / name).read_text()
        assert len((port_dir / "gold_asr.txt").read_text().splitlines()) == 3
    with pytest.raises(NotImplementedError, match="Decode features"):
        greedy.TransducerEvaluator(cfg, REV_VOCAB, str(tmp_path), nbest=2,
                                   device="cpu")
    with pytest.raises(NotImplementedError, match="Decode features"):
        greedy.TransducerEvaluator(cfg, REV_VOCAB, str(tmp_path),
                                   lm_weight=0.5, device="cpu")


def test_serving_decodes_the_transducer(setup):
    """A burst through BatchingTranscriber at beam 1 (greedy) and 2: each
    transcript is the text of the same decode of its utterance alone."""
    cfg, _, _, named, _, _ = setup
    params = checkpoint.params_from_named(named, cfg, device="cpu")
    rng = np.random.default_rng(9)
    utts = [rng.normal(size=(n, FEAT)).astype(np.float32) * 3
            for n in (16, 9, 30, 4)]
    for k in (1, 2):
        with serving.BatchingTranscriber(
                params, cfg, REV_VOCAB, device="cpu", max_batch=2,
                bucket_frames=(16, 32), beam_cfg=BeamConfig(beam_size=k),
                max_wait_ms=5.0) as server:
            got = [f.result() for f in [server.submit(u) for u in utts]]
        decode = transducer_beam.make_decoder(cfg, BeamConfig(beam_size=k))
        want = []
        for u in utts:
            ids = decode(params, {"logmel": u[None], "logmel_len":
                                  np.array([len(u)])})[0][0].numpy()
            _, words = serving.get_relevant_words(
                serving.ids_to_sentence(ids, REV_VOCAB))
            want.append(" ".join(words))
        assert got == want
    assert any(got)


def test_cli_trains_and_evaluates_the_transducer(tmp_path, capsys):
    root = str(tmp_path)
    data = os.path.join(root, "data")
    os.makedirs(data)
    synth.make_vocab_dir(os.path.join(root, "vocab"))
    kw = dict(feat_length=8, char_vocab=20, min_tokens=3, max_tokens=5,
              frames_per_token=4)
    synth.write_speech_corpus(os.path.join(data, "train_1k.0.0001"), 8, **kw)
    synth.write_speech_corpus(os.path.join(data, "dev.0001"), 3, seed=2,
                              **kw)
    synth.write_speech_corpus(os.path.join(data, "eval2000.0001"), 3, seed=3,
                              **kw)

    def args(*extra):
        return ["-data_dir", data, "-vocab_dir", os.path.join(root, "vocab"),
                "-tb_dir", os.path.join(root, "models"), "-hsize", "8",
                "-hsize_dec", "8", "-emb_size", "8", "-joint_dim", "8",
                "-nlc", "2", "-feat_len", "8", "-max_out_char", "8",
                "-buck_batch_sizes", "4", "-steps_per_checkpoint", "2",
                "-max_epochs", "0", "-compute_dtype", "float32",
                "-model_family", "transducer", "-platform", "cpu", *extra]

    main.main(args())
    cfg = main.parse_options(args("-dev"))
    train_dir, best = cfg.train.train_dir, cfg.train.best_model_dir
    assert "rnnt_" in train_dir
    assert sorted(os.listdir(train_dir)) == [
        "asr.ckpt-2.npz", "asr_err.txt", "checkpoint", "parameters.txt",
        "summary"]
    named = checkpoint.load_named(os.path.join(train_dir, "asr.ckpt-2.npz"))
    assert "params/joint/out/kernel" in named
    capsys.readouterr()
    for extra in ((), ("-beam_size", "2")):
        main.main(args("-dev", *extra))
        out = capsys.readouterr().out
        assert f"Using the model from: {train_dir}/asr.ckpt-2.npz" in out
        assert "Total sentences: 3" in out
        with open(os.path.join(best, "decoded_asr.txt")) as f:
            assert len(f.read().splitlines()) == 3
    main.main(args("-test", "-beam_size", "2"))
    assert "Total test files: 1" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="Decode features"):
        main.main(args("-dev", "-beam_size", "2", "-ilm_weight", "0.3"))


def port_model(seed: int = 3):
    """The config and the port's own init on the CPU (no JAX)."""
    cfg = rnnt_cfg()
    return cfg, transducer.init(torch.Generator().manual_seed(seed), cfg, V,
                                device="cpu")


def encoder_states(seed: int, lens=(9, 6, 1, 3)):
    """Random encoder states [4, 9, 16] (scaled so labels get emitted) and
    their lengths."""
    rng = np.random.default_rng(seed)
    enc = (rng.normal(size=(len(lens), 9, 16)) * 2.0).astype(np.float32)
    return torch.tensor(enc), torch.tensor(np.asarray(lens, np.int32))


@pytest.mark.parametrize("shape", [(3, 16, 6, 9, 12), (128, 48, 48, 40, 256),
                                   (64, 400, 101, 1000, 512),
                                   (1, 3, 1, 2, 1)])
def test_auto_chunk_fits_the_budget(shape):
    """The auto-picked t_chunk is JAX's, its recomputed joint fits
    JOINT_CHUNK_BUDGET (or it is 1), and one frame more would not fit (or
    it is T)."""
    B, T, U1, V_, J = shape
    chunk = transducer._auto_chunk(*shape)
    assert chunk == jtransducer._auto_chunk(*shape)
    assert transducer.JOINT_CHUNK_BUDGET == jtransducer.JOINT_CHUNK_BUDGET
    per_frame = B * U1 * (4 * V_ + 2 * J)
    assert 1 <= chunk <= T
    assert chunk == 1 or chunk * per_frame <= transducer.JOINT_CHUNK_BUDGET
    assert chunk == T or (chunk + 1) * per_frame > \
        transducer.JOINT_CHUNK_BUDGET


@pytest.mark.parametrize("t_chunk", [1, 2, 4, 6, 7])
def test_chunked_joint_equals_unchunked(t_chunk):
    """lattice_logprobs in chunks of t_chunk frames of 7 (recomputed in the
    backward) gives the unchunked lattices and the gradients of the
    prediction states and of every joint leaf (1e-5)."""
    _, params = port_model()
    joint = params["joint"]
    leaves = [joint[k][n] for k in ("enc_proj", "pred_proj", "out")
              for n in ("kernel", "bias")]
    for leaf in leaves:
        leaf.requires_grad_(True)
    gen = torch.Generator().manual_seed(t_chunk)
    enc = torch.randn(B, 7, 16, generator=gen)
    pred = torch.randn(B, L, 8, generator=gen, requires_grad=True)
    labels = torch.randint(1, V, (B, L - 1), generator=gen)
    runs = []
    for chunk in (None, t_chunk):
        lat = transducer.lattice_logprobs(params, labels, enc, pred,
                                          t_chunk=chunk)
        runs.append((*lat, *torch.autograd.grad(
            sum((x * x).sum() for x in lat), [pred, *leaves])))
    assert runs[0][0].shape == (B, 7, L) and runs[0][1].shape == (B, 7, L - 1)
    for a, b in zip(*runs):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("split", [1, 2, 4, 7, 8])
def test_greedy_state_carry_equals_one_pass(split):
    """greedy_decode_states over frames [0, split) and then [split, 9) with
    the state carried emits what one pass emits, at the same frames;
    emission frames rise and stay inside each row's length; the carried
    prediction network is the teacher-forced one after the emitted labels
    (1e-5)."""
    cfg, params = port_model()
    enc, n = encoder_states(split)
    cap = {"max_output": 40}
    tokens, frames, (states, pred_p) = transducer.greedy_decode_states(
        params, cfg, enc, n, return_frames=True, return_state=True, **cap)
    emitted = (frames >= 0).sum(1)
    forced = transducer.pred_states(params["pred"], cfg, tokens.long(),
                                    emitted)[torch.arange(len(n)), emitted]
    np.testing.assert_allclose(states[-1].h.numpy(), forced.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        pred_p.numpy(), (forced @ params["joint"]["pred_proj"]["kernel"]
                         + params["joint"]["pred_proj"]["bias"]).numpy(),
        rtol=1e-5, atol=1e-5)
    first, f1, state = transducer.greedy_decode_states(
        params, cfg, enc[:, :split], n.clamp(max=split), return_frames=True,
        return_state=True, **cap)
    second, f2 = transducer.greedy_decode_states(
        params, cfg, enc[:, split:], (n - split).clamp(min=0),
        init_state=state, return_frames=True, **cap)
    for b in range(len(n)):
        k1, k2 = int((f1[b] >= 0).sum()), int((f2[b] >= 0).sum())
        got_t = list(first[b, :k1]) + list(second[b, :k2])
        got_f = list(f1[b, :k1]) + [int(f) + split for f in f2[b, :k2]]
        k = int((frames[b] >= 0).sum())
        assert [int(x) for x in got_t] == [int(x) for x in tokens[b, :k]]
        assert [int(x) for x in got_f] == [int(x) for x in frames[b, :k]]
        assert all(0 < int(x) < V for x in tokens[b, :k])
        f = frames[b, :k].numpy()
        assert np.all(np.diff(f) >= 0) and np.all(f < int(n[b]))
    assert int((frames >= 0).sum()) > 5


@pytest.mark.parametrize("max_expansions", [1, 2, 3])
def test_beam_of_one_is_greedy(max_expansions):
    """At k=1 the beam search takes the argmax of each round, so it emits
    what greedy decoding emits with the same cap of labels per frame."""
    cfg, params = port_model(4)
    enc, n = encoder_states(20 + max_expansions)
    seqs, lens, _ = transducer_beam.transducer_beam_decode(
        params, cfg, enc, n, beam_size=1, max_expansions=max_expansions)
    tokens = transducer.greedy_decode_states(
        params, cfg, enc, n, max_symbols_per_frame=max_expansions)
    np.testing.assert_array_equal(seqs[:, 0].numpy(), tokens.numpy())
    np.testing.assert_array_equal(lens[:, 0].numpy(),
                                  (tokens != 0).sum(1).numpy())
    assert int(lens.sum()) > 3


@pytest.mark.parametrize("k", [2, 3, 4])
def test_beam_scores_bound_the_label_likelihood(k):
    """Each live hypothesis's score is the log-probability of one of its
    alignments, so it is at most log P(tokens | enc), the lattice loss of
    its tokens through pred_states, lattice_logprobs and transducer_loss
    (1e-4); scores come best first and lengths count the tokens."""
    cfg, params = port_model(5)
    enc, n = encoder_states(30 + k)
    seqs, lens, scores = transducer_beam.transducer_beam_decode(
        params, cfg, enc, n, beam_size=k)
    assert torch.all(scores[:, :-1] >= scores[:, 1:])
    np.testing.assert_array_equal(lens.numpy(), (seqs != 0).sum(-1).numpy())
    live = scores > -1e29
    assert int(live.sum()) >= len(n) + 2
    B_, cap = len(n), seqs.shape[-1]
    labels = seqs.reshape(B_ * k, cap).long()
    label_lens = lens.reshape(-1).long()
    pred = transducer.pred_states(params["pred"], cfg, labels, label_lens)
    rep = lambda x: x.repeat_interleave(k, dim=0)  # noqa: E731
    blank_lp, label_lp = transducer.lattice_logprobs(params, labels,
                                                     rep(enc), pred)
    nll = tloss.transducer_loss(blank_lp, label_lp, rep(n), label_lens)
    bound = -nll.reshape(B_, k)
    assert torch.all(scores[live] <= bound[live] + 1e-4)


def test_ctc_labels_drop_go_and_eos():
    """_ctc_labels strips <go>, keeps char_len - 1 labels and zeroes the
    rest (<eos> and padding), as the JAX package's does."""
    batch = make_batch(8)
    labels, lens = step._ctc_labels(
        {k: torch.tensor(v).long() for k, v in batch.items()
         if k.startswith("char")})
    want_labels, want_lens = jstep._ctc_labels(
        {k: v for k, v in batch.items() if k.startswith("char")})
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_labels))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want_lens))
    for row, m, ids in zip(labels.numpy(), lens.numpy(), batch["char"]):
        assert list(row[:m]) == list(ids[1:m + 1]) and not row[m:].any()


def variant_cfg(num_layers_dec: int, depth: int) -> Seq2SeqConfig:
    """rnnt_cfg with another prediction-network and encoder depth."""
    cfg = rnnt_cfg()
    cfg.num_layers = {"char": depth}
    cfg.decoders["char"] = dataclasses.replace(
        cfg.decoders["char"], num_layers_dec=num_layers_dec)
    return cfg


@pytest.mark.parametrize("num_layers_dec,depth", [(1, 1), (3, 2), (2, 3)])
def test_init_names_match_jax_at_other_depths(num_layers_dec, depth):
    """The port's leaf names and shapes are JAX's for other prediction
    network and encoder depths, and load strictly both ways."""
    cfg = variant_cfg(num_layers_dec, depth)
    params = transducer.init(torch.Generator().manual_seed(1), cfg, V,
                             device="cpu")
    named = checkpoint.named_from_params(params)
    shapes = jax.eval_shape(lambda: jtransducer.init(jax.random.PRNGKey(0),
                                                     cfg, V))
    want = {k: tuple(v.shape) for k, v in jckpt.flatten_named(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape), shapes)).items()}
    assert {k: tuple(v.shape) for k, v in named.items()} == want
    assert f"pred/layer_{num_layers_dec - 1}/kernel" in want
    back = checkpoint.named_from_params(checkpoint.params_from_named(
        named, cfg, device="cpu"))
    assert all(np.array_equal(back[k], v) for k, v in named.items())


@pytest.mark.parametrize("num_layers_dec", [1, 2, 3])
def test_pred_states_equal_stepwise_decoding(num_layers_dec):
    """The teacher-forced prediction network (pred_states, on lstm_scan)
    gives at each position u <= label_len what decoding's _pred_step gives
    after <go> and the first u labels (1e-5)."""
    cfg = variant_cfg(num_layers_dec, 2)
    params = transducer.init(torch.Generator().manual_seed(2), cfg, V,
                             device="cpu")
    gen = torch.Generator().manual_seed(num_layers_dec)
    labels = torch.randint(1, V, (B, 5), generator=gen)
    lens = torch.tensor([5, 2, 0])
    labels = torch.where(torch.arange(5)[None] < lens[:, None], labels, 0)
    got = transducer.pred_states(params["pred"], cfg, labels, lens)
    assert got.shape == (B, 6, 8)
    states = tuple(lstm_zero_state((B,), 8, device="cpu")
                   for _ in range(num_layers_dec))
    fed = torch.cat([torch.full((B, 1), 1), labels], dim=1)   # <go> = 1
    for u in range(6):
        out, states = transducer._pred_step(params["pred"], cfg, fed[:, u],
                                            states)
        for b in range(B):
            if u <= int(lens[b]):
                np.testing.assert_allclose(got[b, u].numpy(),
                                           out[b].numpy(), rtol=1e-5,
                                           atol=1e-5)


def test_lattices_are_the_joints_log_softmax():
    """Every entry of lattice_logprobs against the joint written out:
    log_softmax(out(tanh(enc_proj(enc[t]) + pred_proj(pred[u])))), blank
    at id 0 and labels[u] for the label lattice (1e-5)."""
    _, params = port_model()
    gen = torch.Generator().manual_seed(0)
    enc = torch.randn(B, 4, 16, generator=gen)
    pred = torch.randn(B, L, 8, generator=gen)
    labels = torch.randint(1, V, (B, L - 1), generator=gen)
    blank_lp, label_lp = transducer.lattice_logprobs(params, labels, enc,
                                                     pred)
    j = {k: {n: p.numpy().astype(np.float64) for n, p in v.items()}
         for k, v in params["joint"].items()}
    e = enc.numpy() @ j["enc_proj"]["kernel"] + j["enc_proj"]["bias"]
    p = pred.numpy() @ j["pred_proj"]["kernel"] + j["pred_proj"]["bias"]
    logits = (np.tanh(e[:, :, None] + p[:, None]) @ j["out"]["kernel"]
              + j["out"]["bias"])
    lp = logits - np.logaddexp.reduce(logits, axis=-1, keepdims=True)
    np.testing.assert_allclose(blank_lp.numpy(), lp[..., 0], rtol=0,
                               atol=1e-5)
    want = np.take_along_axis(lp[:, :, :-1], labels.numpy()[:, None, :, None]
                              .repeat(4, 1), axis=-1)[..., 0]
    np.testing.assert_allclose(label_lp.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("t_chunk", [1, 3])
def test_model_loss_in_chunks_equals_unchunked(t_chunk):
    """transducer.loss (no dropout) with the joint in chunks equals the
    unchunked loss and its gradient of the joint's output kernel
    (1e-5)."""
    cfg, params = port_model()
    batch = make_batch(12)
    labels, label_lens = step._ctc_labels(
        {k: torch.tensor(v).long() for k, v in batch.items()
         if k.startswith("char")})
    tb = {"logmel": torch.tensor(batch["logmel"]),
          "logmel_len": torch.tensor(batch["logmel_len"]),
          "labels": labels, "label_lens": label_lens}
    kernel_ = params["joint"]["out"]["kernel"].requires_grad_(True)
    runs = []
    for chunk in (None, t_chunk):
        value = transducer.loss(params, cfg, tb, t_chunk=chunk)
        runs.append((value.detach(), torch.autograd.grad(value, kernel_)[0]))
    assert np.isfinite(float(runs[0][0]))
    for a, b in zip(*runs):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cap", [1, 2, 3])
def test_greedy_stops_at_max_output(cap):
    """With room for `cap` tokens, greedy decoding emits the first `cap`
    tokens of the uncapped decode."""
    cfg, params = port_model()
    enc, n = encoder_states(40 + cap)
    full = transducer.greedy_decode_states(params, cfg, enc, n,
                                           max_output=40)
    got = transducer.greedy_decode_states(params, cfg, enc, n,
                                          max_output=cap)
    assert got.shape == (len(n), cap)
    np.testing.assert_array_equal(got.numpy(), full[:, :cap].numpy())
    assert int((full != 0).sum(1).max()) > cap


@pytest.mark.parametrize("per_frame", [1, 2])
def test_greedy_caps_labels_per_frame(per_frame):
    """No frame emits more than max_symbols_per_frame labels."""
    cfg, params = port_model()
    enc, n = encoder_states(50 + per_frame)
    _, frames = transducer.greedy_decode_states(
        params, cfg, enc, n, max_symbols_per_frame=per_frame, max_output=40,
        return_frames=True)
    f = frames.numpy()
    counts = [np.bincount(row[row >= 0]) for row in f if (row >= 0).any()]
    assert counts and max(int(c.max()) for c in counts) <= per_frame


@pytest.mark.parametrize("family", ["attention", "transducer", "ctc"])
def test_family_guards(family):
    """check_supported lets every family of the JAX package through (the
    CTC family since it was ported); check_attention and seq2seq.init
    raise for any family but the attention family, naming the family's
    model."""
    cfg = dataclasses.replace(rnnt_cfg(), model_family=family)
    seq2seq.check_supported(cfg)
    if family != "attention":
        with pytest.raises(ValueError, match=f"models/{family}.py"):
            seq2seq.check_attention(cfg)
        with pytest.raises(ValueError, match="attention decoder"):
            seq2seq.init(torch.Generator(), cfg, device="cpu")
    else:
        seq2seq.check_attention(cfg)
    with pytest.raises(ValueError, match="model family"):
        seq2seq.check_supported(dataclasses.replace(cfg,
                                                    model_family="other"))
