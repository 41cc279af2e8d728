"""Port parity for the CTC family and the hybrid CTC/attention family on
the CPU, against the JAX package (and optax) on the same weights (the
port's init, carried across by name) and the same noise (JAX's own, drawn
from its keys and handed to the port):

- the CTC loss (core/ctc_loss.py) against optax.ctc_loss row by row:
  feasible, infeasible (more labels than frames allow), repeats, logit
  and label paddings, empty labels; and its gradient;
- best path, `ctc.logits` / `loss` / `greedy_decode`, `hybrid.loss` and
  its metrics, and the CTC and hybrid `asr_step` against JAX's
  value_and_grad and optax;
- the `ctc_head` checkpoint names both ways (ctc and hybrid trees);
- `ctc_beam_decode` against JAX's at several beam sizes;
- `CTCEvaluator`'s files and WER against the JAX evaluator's;
- small `Trainer`, `cli.main` and serving runs of both families, and the
  raises that remain.

The configurations are small: a 2-layer pyramidal BiLSTM encoder (H=8)
and V=9 (the CTC family), and the recipe of test_torch_train_step with
ctc_weight 0.3 (the hybrid; its char task against JAX, which then
compiles one decoder, and char + phone in the port's own runs), B=3,
T=16.
Tolerances (float32, sums in other orders): losses 1e-5 relative (the
CTC loss 1e-5 of max(|loss|, 1)), logits 1e-5, gradients 1e-4 of each
leaf's largest value, params after the step 1e-6 where the gradient is
well above that, beam scores 1e-4; tokens exactly. The JAX side compiles
twice, in two module fixtures.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from e2e_asr_tpu.config import LMConfig, Seq2SeqConfig
from e2e_asr_tpu.core import checkpoint as jckpt
from e2e_asr_tpu.eval import ctc_beam as jctc_beam
from e2e_asr_tpu.eval import greedy as jgreedy
from e2e_asr_tpu.models import ctc as jctc
from e2e_asr_tpu.models import hybrid as jhybrid
from e2e_asr_tpu.train import step as jstep
from e2e_asr_tpu_torch.cli import main
from e2e_asr_tpu_torch.config import BeamConfig
from e2e_asr_tpu_torch.core import checkpoint
from e2e_asr_tpu_torch.core.ctc_loss import ctc_loss, ctc_loss_mean
from e2e_asr_tpu_torch.data import synth
from e2e_asr_tpu_torch.eval import beam_eval, ctc_beam, greedy, serving
from e2e_asr_tpu_torch.models import ctc, encoder, hybrid, seq2seq
from e2e_asr_tpu_torch.train import step
from e2e_asr_tpu_torch.train.loop import Trainer
from tests.test_torch_recipe import recipe_cfg, write_corpus
from tests.test_torch_train_step import (B, T, V, assert_leaves_close,
                                         draw_jax_noise, make_batch,
                                         port_noise, train_cfg)

torch.set_num_threads(1)
REV_VOCAB = ["<pad>", "<go>", "<eos>", " ", "a", "b", "c", "d", "e"]
KEY = jax.random.PRNGKey(7)


def quick_jit(fn, *args):
    """fn(*args) compiled with XLA's backend optimizations off (the same
    float32 operations) for about half the compile time."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})(*args)


def ctc_cfg(**kw) -> Seq2SeqConfig:
    """The CTC family at small width (V=9 through the char decoder's
    vocabulary, as the JAX package sizes its head)."""
    cfg = train_cfg()
    return dataclasses.replace(
        cfg, tasks=["char"], num_layers={"char": 2},
        max_output={"char": 8}, decoders={"char": cfg.decoders["char"]},
        model_family="ctc", **kw)


def hybrid_cfg(tasks=("char",)) -> Seq2SeqConfig:
    """The hybrid at small width: the char task (JAX's reference compiles
    one decoder), or the char + phone recipe."""
    cfg = train_cfg()
    return dataclasses.replace(
        cfg, tasks=list(tasks),
        num_layers={t: cfg.num_layers[t] for t in tasks},
        max_output={t: cfg.max_output[t] for t in tasks},
        decoders={t: cfg.decoders[t] for t in tasks}, ctc_weight=0.3)


def carried(cfg, seed: int):
    """The port's init of cfg's family by name, and as JAX's pytree (laid
    out by jax.eval_shape of the JAX init, so nothing compiles)."""
    named = checkpoint.named_from_params(step.init_params(
        torch.Generator().manual_seed(seed), cfg, device="cpu"))
    shapes = jax.eval_shape(lambda: jstep.init_params(jax.random.PRNGKey(0),
                                                      cfg))
    return named, jax.tree_util.tree_map(
        jnp.asarray, jckpt.unflatten_named(shapes, named))


def ctc_noise(cfg, key):
    """JAX's encoder keep-masks for ctc.loss(rng=key): the encoder draws
    from the step's key itself (models/ctc.py:68, encoder.py:258)."""
    t, masks = T, []
    for i, reduce in enumerate(encoder.layer_plan(cfg.encoder, 2)):
        masks.append(jax.random.bernoulli(
            jax.random.fold_in(key, i + 1), cfg.encoder.out_prob,
            (t, B, 2 * cfg.encoder.hidden_size)))
        t = -(-t // cfg.encoder.skip_step) if reduce else t
    return masks


def with_labels(batch: dict) -> dict:
    out = dict(batch)
    out["labels"], out["label_lens"] = jstep._ctc_labels(batch)
    return out


@pytest.fixture(scope="module")
def models():
    """Both families' weights, JAX's losses, gradients, noise, optax
    updates, CTC logits and best-path decode, in one compile."""
    cfg_c, cfg_h = ctc_cfg(), hybrid_cfg()
    named_c, jp_c = carried(cfg_c, 3)
    named_h, jp_h = carried(cfg_h, 4)
    batch = {k: v for k, v in make_batch(5).items()
             if not k.startswith("phone")}
    batch_c = batch
    opt = jstep.make_optimizer(cfg_c.learning_rate, cfg_c.max_gradient_norm)

    def run(pc, ph, bc, bh):
        jc = with_labels(bc)
        loss_c, g_c = jax.value_and_grad(
            lambda p: jctc.loss(p, cfg_c, jc, rng=KEY))(pc)
        (loss_h, metrics), g_h = jax.value_and_grad(
            lambda p: jhybrid.loss(p, cfg_h, with_labels(bh),
                                   ctc_weight=0.3, rng=KEY),
            has_aux=True)(ph)
        upd_c, _ = opt.update(g_c, opt.init(pc), pc)
        upd_h, _ = opt.update(g_h, opt.init(ph), ph)
        lg, lens = jctc.logits(pc, cfg_c, bc["logmel"], bc["logmel_len"])
        return {"ctc": (loss_c, g_c, optax.apply_updates(pc, upd_c),
                        ctc_noise(cfg_c, KEY)),
                "hybrid": (loss_h, metrics, g_h,
                           optax.apply_updates(ph, upd_h),
                           draw_jax_noise(cfg_h, KEY, bh)),
                "logits": (lg, lens,
                           jctc.greedy_decode(pc, cfg_c, bc["logmel"],
                                              bc["logmel_len"]))}

    out = quick_jit(run, jp_c, jp_h,
                    *[{k: jnp.asarray(v) for k, v in b.items()}
                      for b in (batch_c, batch)])
    return {"ctc": (cfg_c, named_c, batch_c), "hybrid": (cfg_h, named_h,
                                                         batch)}, out


# -- the CTC loss against optax --------------------------------------------

# (frames, labels): feasible; repeats; infeasible (7 frames needed, 6
# given); infeasible by its length (5 needed, 3 given); no labels; one
# label on 2 frames; four distinct labels on all frames; no frames.
LOSS_ROWS = [(6, [1, 3, 4]), (6, [3, 3, 1]), (6, [1, 1, 1, 1]),
             (3, [1, 3, 4, 4]), (4, []), (2, [4]), (6, [1, 2, 3, 4]),
             (0, [2, 2])]
LOSS_T, LOSS_N, LOSS_V = 6, 4, 5
# Rows whose labels need more frames than they have: their log-space
# values sit near -log_epsilon * frames (about 1e5), where a float32 ulp
# is 0.008 nats, so the occupancies exp(alpha + beta - logZ) of either
# implementation carry about 1% of rounding: their gradients are held to
# 2e-2 of the row's largest, the others to 1e-4.
INFEASIBLE = {2, 3, 7}


def loss_inputs():
    rng = np.random.default_rng(11)
    R = len(LOSS_ROWS)
    logits = (rng.normal(size=(R, LOSS_T, LOSS_V)) * 2).astype(np.float32)
    labels = np.zeros((R, LOSS_N), np.int32)
    logit_pad = np.ones((R, LOSS_T), np.float32)
    label_pad = np.ones((R, LOSS_N), np.float32)
    for i, (frames, lab) in enumerate(LOSS_ROWS):
        labels[i, :len(lab)] = lab
        logit_pad[i, :frames] = 0.0
        label_pad[i, :len(lab)] = 0.0
    return logits, logit_pad, labels, label_pad


BEAM_SIZES = (1, 3)


def best_path_inputs():
    """Frame logits with exact ties (the first maximum wins), repeats
    across blanks and ragged lengths (one of 0 frames)."""
    rng = np.random.default_rng(12)
    lg = rng.normal(size=(5, 10, 6)).astype(np.float32)
    lg[0, 3] = lg[0, 3, 2]              # a tie across the whole frame
    lg[1, :, 4] += 5.0                  # one label held: one token
    lg[2, ::2, 0] += 5.0                # blanks between repeats
    lg[2, 1::2, 3] += 5.0
    return lg, np.array([10, 7, 10, 0, 4], np.int32)


@pytest.fixture(scope="module")
def ops():
    """optax's per-row CTC loss and its gradients, JAX's best path, and
    JAX's prefix beam search at beam sizes 1, 2, 3 and 5, in one
    compile."""
    loss_args = loss_inputs()
    lg, lens = best_path_inputs()
    lp = torch.log_softmax(torch.tensor(lg[:4]), -1).numpy()

    def run(logits, logit_pad, labels, label_pad, bp_lg, bp_lens, lp):
        per_row = lambda x: optax.ctc_loss(  # noqa: E731
            x, logit_pad, labels, label_pad)
        loss, vjp = jax.vjp(per_row, logits)
        beams = {k: jctc_beam.ctc_beam_decode(lp, bp_lens[:4], beam_size=k)
                 for k in BEAM_SIZES}
        return (loss, vjp(jnp.ones_like(loss))[0],
                jctc.best_path_from_logits(bp_lg, bp_lens), beams)

    return quick_jit(run, *loss_args, lg, lens, lp), (lg, lens, lp)


@pytest.mark.parametrize("row", range(len(LOSS_ROWS)))
def test_ctc_loss_matches_optax(ops, row):
    (want, want_grad, _, _), _ = ops
    args = [torch.tensor(a) for a in loss_inputs()]
    logits = args[0].requires_grad_(True)
    loss = ctc_loss(logits, *args[1:])
    grad, = torch.autograd.grad(loss.sum(), logits)
    w = float(want[row])
    assert abs(float(loss[row].detach()) - w) <= 1e-5 * max(abs(w), 1.0)
    g = np.asarray(want_grad[row])
    tol = 2e-2 if row in INFEASIBLE else 1e-4
    np.testing.assert_allclose(grad[row].numpy(), g, rtol=0,
                               atol=tol * max(np.abs(g).max(), 1e-6))
    assert np.isfinite(w) and (w > 1e4) == (row in INFEASIBLE)


def test_ctc_loss_against_torch_where_feasible(ops):
    """torch.nn.functional.ctc_loss agrees on the feasible rows and
    returns inf on the infeasible ones, where optax's recursion (and the
    port's) stays finite: another function at the edges."""
    (want, _, _, _), _ = ops
    logits, logit_pad, labels, label_pad = loss_inputs()
    lp = torch.log_softmax(torch.tensor(logits), -1).transpose(0, 1)
    frames = torch.tensor((1 - logit_pad).sum(1)).long()
    n = torch.tensor((1 - label_pad).sum(1)).long()
    ref = torch.nn.functional.ctc_loss(lp, torch.tensor(labels).long(),
                                       frames, n, reduction="none")
    for row in range(len(LOSS_ROWS)):
        if row in INFEASIBLE:
            assert not torch.isfinite(ref[row]) and np.isfinite(want[row])
        else:
            np.testing.assert_allclose(float(ref[row]), float(want[row]),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("row", range(5))
def test_best_path_matches_jax(ops, row):
    (_, _, want, _), (lg, lens, _) = ops
    got = ctc.best_path_from_logits(torch.tensor(lg), torch.tensor(lens))
    np.testing.assert_array_equal(got[row].numpy(), np.asarray(want)[row])
    assert got.dtype == torch.int32 and got.shape == (5, 10)


@pytest.mark.parametrize("k", BEAM_SIZES)
def test_ctc_beam_decode_matches_jax(ops, k):
    """Prefixes and lengths exactly, scores within 1e-4, best first."""
    (_, _, _, beams), (_, lens, lp) = ops
    seqs, out_lens, scores = ctc_beam.ctc_beam_decode(
        torch.tensor(lp), torch.tensor(lens[:4]), beam_size=k)
    want = [np.asarray(x) for x in beams[k]]
    np.testing.assert_array_equal(seqs.numpy(), want[0])
    np.testing.assert_array_equal(out_lens.numpy(), want[1])
    np.testing.assert_allclose(scores.numpy(), want[2], rtol=1e-4,
                               atol=1e-4)
    assert torch.all(scores[:, :-1] >= scores[:, 1:])


# -- the models and their steps against JAX --------------------------------

def port_batch(batch: dict) -> dict:
    out = {k: torch.tensor(v) for k, v in batch.items()}
    out["labels"], out["label_lens"] = step._ctc_labels(
        {k: v.long() for k, v in out.items() if k.startswith("char")})
    return out


def test_ctc_logits_and_best_path_decode_match_jax(models):
    (setups, out) = models
    cfg, named, batch = setups["ctc"]
    lg, lens, tokens = out["logits"]
    params = checkpoint.params_from_named(named, cfg, device="cpu")
    pb = port_batch(batch)
    got, got_lens = ctc.logits(params, cfg, pb["logmel"], pb["logmel_len"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(lg),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(lens))
    dec = ctc.greedy_decode(params, cfg, pb["logmel"], pb["logmel_len"])
    np.testing.assert_array_equal(dec.numpy(), np.asarray(tokens))


@pytest.mark.parametrize("family", ["ctc", "hybrid"])
def test_model_loss_and_gradients_match_jax(models, family):
    """The family's training loss (encoder dropout on; the hybrid's
    decoders with dropout and scheduled sampling) and every gradient."""
    setups, out = models
    cfg, named, batch = setups[family]
    leaves = {k: torch.tensor(v, requires_grad=True)
              for k, v in named.items()}
    params = checkpoint._fill(checkpoint.params_from_named(
        named, cfg, device="cpu"), leaves)
    pb = port_batch(batch)
    if family == "ctc":
        want_loss, want_g, _, masks = out["ctc"]
        noise = {"encoder": {i + 1: torch.tensor(np.asarray(m))
                             for i, m in enumerate(masks)}}
        loss = ctc.loss(params, cfg, pb, train=True, noise=noise)
    else:
        want_loss, metrics, want_g, _, drawn = out["hybrid"]
        loss, got = hybrid.loss(params, cfg, pb, ctc_weight=0.3,
                                noise=port_noise(cfg, drawn))
        assert set(got) == set(metrics) == {"attention", "ctc", "char"}
        for name, w in metrics.items():
            np.testing.assert_allclose(float(got[name]), float(w),
                                       rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    assert all(g is not None for g in grads)
    assert_leaves_close({k: g.numpy() for k, g in zip(leaves, grads)},
                        jckpt.flatten_named(want_g))


@pytest.mark.parametrize("family", ["ctc", "hybrid"])
def test_asr_step_matches_jax_and_optax(models, family):
    """One asr_step: its loss and per-term metrics, and the params after
    clip + Adam against optax where the gradient is well above the
    tolerance."""
    setups, out = models
    cfg, named, batch = setups[family]
    lm_cfg = LMConfig(vocab_size=V)
    state = step.create_state(checkpoint.params_from_named(named, cfg,
                                                           "cpu"),
                              cfg, lm_cfg, device="cpu")
    asr_step, _ = step.make_train_step(cfg, lm_cfg, device="cpu")
    if family == "ctc":
        want_loss, want_g, want_p, masks = out["ctc"]
        noise = {"encoder": {i + 1: torch.tensor(np.asarray(m))
                             for i, m in enumerate(masks)}}
        names = {"loss", "loss_ctc"}
    else:
        want_loss, _, want_g, want_p, drawn = out["hybrid"]
        noise = port_noise(cfg, drawn)
        names = {"loss", "loss_attention", "loss_ctc", "loss_char"}
    new_state, metrics = asr_step(state, batch, None, noise)
    assert set(metrics) == names
    np.testing.assert_allclose(float(metrics["loss"]), float(want_loss),
                               rtol=1e-5)
    got = checkpoint.named_from_params(new_state.params)
    want = jckpt.flatten_named(want_p)
    moved = 0
    for name, g in jckpt.flatten_named(want_g).items():
        big = np.abs(g) > max(1e-2 * np.abs(g).max(), 1e-6)
        moved += int(big.sum())
        np.testing.assert_allclose(got[name][big], np.asarray(want[name])[big],
                                   rtol=0, atol=1e-6, err_msg=name)
    assert moved > 300 and int(new_state.global_step) == 1


@pytest.mark.parametrize("w", [0.0, 0.3, 1.0])
def test_hybrid_loss_combines_the_terms(w):
    """The char + phone hybrid (dropout and sampling off): the attention
    term is apply_train's task average, the CTC term the CTC loss of the
    head on the char depth, and total = (1 - w) attention + w CTC; at
    w = 0 the attention family's loss."""
    cfg = hybrid_cfg(("char", "phone"))
    cfg = dataclasses.replace(cfg, ctc_weight=w, encoder=dataclasses.replace(
        cfg.encoder, out_prob=1.0), decoders={
            t: dataclasses.replace(d, samp_prob=0.0, out_prob_dec=1.0)
            for t, d in cfg.decoders.items()})
    params = hybrid.init(torch.Generator().manual_seed(6), cfg, device="cpu")
    pb = port_batch(make_batch(6))
    total, metrics = hybrid.loss(params, cfg, pb, ctc_weight=w)
    attention, tasks = seq2seq.apply_train(params, cfg, pb)
    lg, lens = ctc.logits(dict(params), cfg, pb["logmel"], pb["logmel_len"])
    ctc_term = ctc_loss_mean(lg, lens, pb["labels"], pb["label_lens"])
    for got, want in ((metrics["attention"], attention),
                      (metrics["char"], tasks["char"]),
                      (metrics["phone"], tasks["phone"]),
                      (metrics["ctc"], ctc_term),
                      (total, (1 - w) * attention + w * ctc_term)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(metrics["attention"]),
                               float(tasks["char"] + tasks["phone"]) / 2,
                               rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_peaked_beam_equals_best_path(seed):
    """On peaked frame posteriors the prefix beam's best prefix is the
    best path's collapse, at every beam size."""
    rng = np.random.default_rng(seed)
    lg = rng.normal(size=(3, 12, 6)).astype(np.float32)
    lg[np.arange(3)[:, None], np.arange(12)[None, :],
       rng.integers(0, 6, size=(3, 12))] += 12.0
    lens = torch.tensor([12, 9, 5])
    best = ctc.best_path_from_logits(torch.tensor(lg), lens)
    for k in (1, 2, 4):
        seqs, out_lens, _ = ctc_beam.ctc_beam_decode(
            torch.log_softmax(torch.tensor(lg), -1), lens, beam_size=k)
        np.testing.assert_array_equal(seqs[:, 0, :12].numpy(), best.numpy())
        np.testing.assert_array_equal(out_lens[:, 0].numpy(),
                                      (best != 0).sum(1).numpy())


# -- checkpoint names -------------------------------------------------------

@pytest.mark.parametrize("family,tasks,depth", [
    ("ctc", ("char",), 2), ("ctc", ("char", "phone"), 3),
    ("hybrid", ("char",), 2), ("hybrid", ("char", "phone"), 2)])
def test_ctc_head_names_both_ways(family, tasks, depth):
    """The port's tree has JAX's leaf names and shapes (ctc_head/kernel
    [2H, V] and /bias; the CTC family has no decoder), and loads strictly
    both ways."""
    base = hybrid_cfg(tasks) if family == "hybrid" else ctc_cfg()
    layers = {"char": depth, "phone": 1}
    cfg = dataclasses.replace(
        base, tasks=list(tasks), num_layers={t: layers[t] for t in tasks},
        decoders={t: train_cfg().decoders[t] for t in tasks})
    named, _ = carried(cfg, 1)
    shapes = jax.eval_shape(lambda: jstep.init_params(jax.random.PRNGKey(0),
                                                      cfg))
    want = {k: tuple(v.shape) for k, v in jckpt.flatten_named(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape), shapes)).items()}
    assert {k: tuple(v.shape) for k, v in named.items()} == want
    assert want["ctc_head/kernel"] == (16, V)
    assert (family == "hybrid") == any(k.startswith("decoder_")
                                       for k in want)
    assert f"encoder/layer_{max(layers[t] for t in tasks)}/fw/kernel" in want
    back = checkpoint.named_from_params(checkpoint.params_from_named(
        named, cfg, device="cpu"))
    assert all(np.array_equal(back[k], v) for k, v in named.items())
    with pytest.raises(ValueError, match="missing"):
        checkpoint.params_from_named(
            {k: v for k, v in named.items() if k != "ctc_head/bias"}, cfg,
            device="cpu")


# -- evaluation, training, command line, serving -----------------------------

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


@pytest.mark.parametrize("k", [1, 2])
def test_ctc_evaluator_files_and_wer_match_jax(models, tmp_path, k):
    """CTCEvaluator (best path at k = 1, the prefix beam at 2) against the
    JAX evaluator's scoring and files on the port's tokens (JAX's decode
    is stubbed, so nothing compiles)."""
    cfg, named, _ = models[0]["ctc"]
    params = checkpoint.params_from_named(named, cfg, device="cpu")
    params["ctc_head"]["kernel"] *= 20.0       # peaked: tokens get emitted
    batches = eval_batches(21)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    evaluator = greedy.CTCEvaluator(cfg, REV_VOCAB, str(port_dir),
                                    beam_size=k, device="cpu")
    tokens = []
    real = evaluator._decode
    evaluator._decode = lambda p, f, n: tokens.append(real(p, f, n)) or \
        tokens[-1]
    wer = evaluator(params, batches)
    assert sum(int((t != 0).sum()) for t in tokens) > 3
    jev = jgreedy.CTCEvaluator(cfg, REV_VOCAB, str(jax_dir), beam_size=k)
    feed = iter(tokens)
    jev._decode = lambda **kw: next(feed).numpy()
    assert wer == jev(None, batches)
    for kind in ("gold", "raw", "decoded"):
        name = f"{kind}_asr.txt"
        assert (port_dir / name).read_text() == (jax_dir / name).read_text()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_ctc"))
    return root, write_corpus(root, synth)


@pytest.mark.parametrize("family", ["ctc", "hybrid"])
def test_trainer_trains_evaluates_and_resumes(corpus, capsys, family):
    """One epoch of the Trainer (two ASR steps; the hybrid with the LM
    task, the CTC family without): a cadence with greedy dev WER
    (CTCEvaluator or GreedyEvaluator) and a save holding ctc_head; a
    second Trainer resumes the saved state."""
    root, sizes = corpus
    cfg = recipe_cfg(root, sizes, max_epochs=0,
                     lm_prob=0.0 if family == "ctc" else 0.5,
                     train_dir=os.path.join(root, f"train_{family}"))
    model = dataclasses.replace(cfg.model, ctc_weight=0.3)
    if family == "ctc":
        model = dataclasses.replace(cfg.model, model_family="ctc",
                                    tasks=["char"],
                                    num_layers={"char": 2})
    cfg = dataclasses.replace(cfg, model=model)
    state = Trainer(cfg, device="cpu").train()
    assert int(state.global_step) == 2
    assert (int(state.lm_global_step) > 0) == (family == "hybrid")
    named, _ = checkpoint.restore_latest(cfg.train.train_dir)
    assert "params/ctc_head/kernel" in named
    assert ("params/decoder_char/embedding" in named) == (family == "hybrid")
    assert "ASR error:" in capsys.readouterr().out
    resume = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, max_epochs=-1))         # restore, train no further
    again = step.state_to_named(Trainer(resume, device="cpu").train())
    assert again.keys() == named.keys()
    assert all(np.array_equal(again[k], v) for k, v in named.items())


def cli_workspace(root: str):
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
                "-hsize_dec", "8", "-emb_size", "8", "-attn_vec_size", "8",
                "-nlc", "2", "-feat_len", "8", "-max_out_char", "8",
                "-buck_batch_sizes", "4", "-steps_per_checkpoint", "2",
                "-max_epochs", "0", "-lm_prob", "0", "-compute_dtype",
                "float32", "-platform", "cpu", *extra]
    return args


@pytest.mark.parametrize("family", ["ctc", "hybrid"])
def test_cli_trains_and_evaluates(tmp_path, capsys, family):
    """`-model_family ctc`: train, `-dev` greedy and at beam 2, `-test`;
    `-ctc_weight 0.3`: train, `-dev -beam_size 2 -joint_ctc 0.3` at a batch
    of 1 and of 4, `-test`. A non-hybrid checkpoint cannot decode jointly."""
    args = cli_workspace(str(tmp_path))
    flag = (["-model_family", "ctc"] if family == "ctc"
            else ["-ctc_weight", "0.3"])
    main.main(args(*flag))
    cfg = main.parse_options(args(*flag, "-dev"))
    train_dir, best = cfg.train.train_dir, cfg.train.best_model_dir
    assert ("ctcfam_" if family == "ctc" else "ctc_w0.3_") in train_dir
    named = checkpoint.load_named(os.path.join(train_dir, "asr.ckpt-2.npz"))
    assert "params/ctc_head/kernel" in named
    capsys.readouterr()
    runs = ([("-dev",), ("-dev", "-beam_size", "2")] if family == "ctc" else
            [("-dev", "-beam_size", "2", "-joint_ctc", "0.3", *b)
             for b in (("-buck_batch_sizes", "1"), ())])
    for extra in runs:
        main.main(args(*flag, *extra))
        out = capsys.readouterr().out
        assert f"Using the model from: {train_dir}/asr.ckpt-2.npz" in out
        name = "decoded_asr.txt" if family == "ctc" else "raw_2.txt"
        with open(os.path.join(best, name)) as f:
            assert len(f.read().splitlines()) == 3
    main.main(args(*flag, "-test", "-beam_size", "2",
                   *(() if family == "ctc" else ("-joint_ctc", "0.5"))))
    assert "Total test files: 1" in capsys.readouterr().out
    if family == "hybrid":
        with pytest.raises(ValueError, match="hybrid checkpoint"):
            main.main(args("-dev", "-beam_size", "2", "-joint_ctc", "0.3",
                           "-run_id", "9"))


@pytest.mark.parametrize("family", ["ctc", "hybrid"])
def test_serving_decodes_both_families(models, family):
    """A burst through BatchingTranscriber (the CTC family at beam 1 and
    2, the hybrid by joint beams at 0.3): each transcript is the text of
    the same decode of its utterance alone."""
    cfg, named, _ = models[0][family]
    params = checkpoint.params_from_named(named, cfg, device="cpu")
    params["ctc_head"]["kernel"] *= 20.0
    rng = np.random.default_rng(9)
    utts = [rng.normal(size=(n, 6)).astype(np.float32) * 3
            for n in (16, 9, 30, 4)]
    beams = ([BeamConfig(beam_size=k) for k in (1, 2)] if family == "ctc"
             else [BeamConfig(beam_size=2, max_steps=8, joint_ctc=0.3)])
    for bc in beams:
        with serving.BatchingTranscriber(
                params, cfg, REV_VOCAB, device="cpu", max_batch=2,
                bucket_frames=(16, 32), beam_cfg=bc,
                max_wait_ms=5.0) as server:
            got = [f.result() for f in [server.submit(u) for u in utts]]
        decode = (ctc_beam.make_decoder if family == "ctc"
                  else beam_eval.make_beam_decoder)(cfg, bc)
        want = []
        for u in utts:
            ids = decode(params, {"logmel": u[None], "logmel_len":
                                  np.array([len(u)])})[0][0].numpy()
            _, words = serving.get_relevant_words(
                serving.ids_to_sentence(ids, REV_VOCAB))
            want.append(" ".join(words))
        assert got == want


def test_what_the_ctc_families_lack_raises(models, tmp_path):
    """LM fusion, lm_rescore, n-best and biasing of the CTC family raise
    NotImplementedError naming 'Decode features'; its ILM subtraction and
    LM task raise ValueError, as in the JAX package; -ctc_rescore keeps
    raising."""
    cfg = models[0]["ctc"][0]
    todo = "Decode features"
    for kw in (dict(nbest=2), dict(lm_params={}, lm_weight=0.5),
               dict(bias=({}, 1.0))):
        with pytest.raises(NotImplementedError, match=todo):
            greedy.CTCEvaluator(cfg, REV_VOCAB, str(tmp_path), device="cpu",
                                **kw)
    with pytest.raises(ValueError, match="lm_path"):
        greedy.CTCEvaluator(cfg, REV_VOCAB, str(tmp_path), lm_weight=0.5,
                            device="cpu")
    with pytest.raises(NotImplementedError, match=todo):
        ctc_beam.ctc_beam_decode(torch.zeros(1, 3, V), torch.tensor([3]),
                                 lm_params={}, lm_weight=0.5)
    with pytest.raises(NotImplementedError, match=todo):
        ctc_beam.make_decoder(cfg, BeamConfig(beam_size=2, lm_rescore=0.5))
    with pytest.raises(ValueError, match="internal"):
        ctc_beam.make_decoder(cfg, BeamConfig(beam_size=2, ilm_weight=0.3))
    with pytest.raises(NotImplementedError, match="CTC family"):
        beam_eval.BeamEvaluator(hybrid_cfg(), BeamConfig(ctc_rescore=0.3),
                                REV_VOCAB, str(tmp_path), device="cpu")
    args = cli_workspace(str(tmp_path))
    with pytest.raises(ValueError, match="lm_prob 0"):
        main.main(args("-model_family", "ctc", "-lm_prob", "0.5"))
    with pytest.raises(ValueError, match="internal LM"):
        main.main(args("-model_family", "ctc", "-dev", "-ilm_weight", "0.3"))
