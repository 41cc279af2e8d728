"""Port parity for the deep decoders on the CPU, where the wrappers of
kernels #8/#9 and #10 run their plain versions: stacked decoder cells,
SimpleProjection (lm_hidden != hidden) and ind_softmax, against the JAX
package.

- `dec_train_reference` / `dec_train_gru_reference` with autograd against
  the TPU kernels `_fwd_call` and `_bwd_call` (ops/dec_train_pallas.py,
  ops/dec_train_gru_pallas.py) in interpret mode: logits and every
  gradient, at depths 1 to 3 with SimpleProjection on and off, each with
  dropout and sampling on and off. JAX compiles once per (cell, depth,
  SimpleProjection); "off" reaches it as all-one masks and zero coins (the
  same function), while the port takes its own off branches.
- `weight_args` against the reference's `_weight_args`, ind_softmax
  included, at every depth;
- the fused form against the port's own plain scan over the whole product
  of cell, depth, SimpleProjection, ind_softmax, dropout and sampling;
- `apply_train` (scan and fused) against JAX's `apply_train` on its fused
  path, a 2-layer char decoder with SimpleProjection and ind_softmax;
- the deep char + phone `asr_step` against JAX's value_and_grad and optax;
- a JAX-initialised deep checkpoint in the port: greedy and beam decodes
  (both beam routes) equal JAX's;
- `cli.main -num_layers_dec 2 -lm_hsize w -ind_softmax`: train and `-dev`
  on the CPU, `parameters.txt` byte-equal to the JAX command's.

Tolerances (float32, sums in other orders): logits 1e-5 absolute,
gradients 1e-4 relative to each leaf's largest value; the step's loss 1e-5
relative and its params 1e-6 where the gradient is large; decodes exactly.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from e2e_asr_tpu.cli import main as jmain
from e2e_asr_tpu.config import BeamConfig as JBeamConfig
from e2e_asr_tpu.config import LMConfig
from e2e_asr_tpu.core import checkpoint as jckpt
from e2e_asr_tpu.eval import beam as jbeam
from e2e_asr_tpu.models import attn_decoder as jdec
from e2e_asr_tpu.models import seq2seq as jseq2seq
from e2e_asr_tpu.ops import dec_train_gru_pallas as dtgp
from e2e_asr_tpu.ops import dec_train_pallas as dtp
from e2e_asr_tpu.train import step as jstep
from e2e_asr_tpu_torch.cli import main
from e2e_asr_tpu_torch.config import BeamConfig, DecoderConfig
from e2e_asr_tpu_torch.core import checkpoint
from e2e_asr_tpu_torch.eval import beam
from e2e_asr_tpu_torch.kernels import dec_train, dec_train_gru
from e2e_asr_tpu_torch.models import attn_decoder, seq2seq
from e2e_asr_tpu_torch.train import step
from tests.test_torch_beam_mega import _assert_same
from tests.test_torch_cli import _args, workspace  # noqa: F401
from tests.test_torch_train_step import (B, L, V, assert_leaves_close,
                                         draw_jax_noise, init_both,
                                         make_batch, port_noise, quick_jit,
                                         train_cfg)

torch.set_num_threads(1)

# The kernel-level shapes: steps, batch, decoder hidden, its input,
# encoder width, attention, vocabulary, frames; lm_hidden G_SP brings
# SimpleProjection.
S, NB, D, M, E, A, VK, T = 5, 3, 8, 6, 10, 7, 9, 6
G_SP = 12


def deep_cfg(cfg=None, use_lstm=True):
    """train_cfg() with a 2-layer char decoder, lm_hidden 12 != hidden 8
    (SimpleProjection, in both decoders by the config rule) and
    ind_softmax; GRU cells throughout with use_lstm=False."""
    cfg = cfg or train_cfg()
    decoders = {t: dataclasses.replace(
        d, lm_hidden_size=G_SP, ind_softmax=True, use_lstm=use_lstm,
        num_layers_dec=2 if t == "char" else 1)
        for t, d in cfg.decoders.items()}
    return dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, use_lstm=use_lstm),
        decoders=decoders)


def kernel_case(use_lstm, NL, sp, seed):
    """Random weights in the port's order, inputs and noise of the fused
    form (sampling coins with row 0 zero, dropout masks, the logits'
    cotangent), as numpy."""
    rng = np.random.default_rng(seed)
    G = G_SP if sp else D

    def w(*shape):
        return (rng.normal(size=shape) * 0.3).astype(np.float32)

    HID = D if sp else G
    if use_lstm:
        weights = [w(VK, 4 * G), w(G, 4 * G), w(HID + E, M), w(M),
                   w(M + D, 4 * D), w(4 * D), w(D, A), w(A), w(A),
                   w(D + E, D), w(D), w(D, VK), w(VK)]
        for _ in range(NL - 1):
            weights += [w(2 * D, 4 * D), w(4 * D)]
        x = [w(S, NB, 4 * G)]
    else:
        weights = [w(VK, 2 * G), w(VK, G), w(G, 2 * G), w(G, G),
                   w(HID + E, M), w(M), w(D, A), w(A), w(A), w(D + E, D),
                   w(D), w(D, VK), w(VK)]
        for layer in range(NL):
            K = M if layer == 0 else D
            weights += [w(K, 2 * D), w(2 * D), w(D, 2 * D), w(K, D), w(D),
                        w(D, D)]
        x = [w(S, NB, 2 * G), w(S, NB, G)]
    if sp:
        weights += [w(G, D), w(D)]
    lens = np.array([T, 4, 2])
    amask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    gum = -np.log(-np.log(rng.uniform(1e-6, 1, size=(S, NB, VK))))
    gum[0] = 0
    flag = np.array([0, 1, 0, 1, 1], np.float32)[:, None].repeat(NB, 1)
    keep = lambda *s: ((rng.random(s) < 0.8) / 0.8).astype(np.float32)  # noqa
    return dict(weights=weights, hf=w(NB, T, A), enc=w(NB, T, E),
                amask=amask, x=x, gum=gum.astype(np.float32), flag=flag,
                lm=keep(S, NB, G), inter=keep(max(NL - 1, 1), S, NB, D)[
                    :NL - 1], dlog=w(S, NB, VK))


def jax_weights(weights, use_lstm, NL, sp):
    """The port's weights in the reference's _weight_args layout: biases as
    [1, n] rows, each LSTM layer's kernel split into its input and
    recurrent parts."""
    row = lambda a: jnp.asarray(a)[None, :]  # noqa: E731
    j = [jnp.asarray(a) if a.ndim == 2 else row(a) for a in weights]
    if not use_lstm:
        return j
    out = j[:4] + [j[4][:M], j[5], j[4][M:]] + j[6:13]
    for layer in range(NL - 1):
        k, b = j[13 + 2 * layer], j[14 + 2 * layer]
        out += [k[:D], b, k[D:]]
    return out + (j[-2:] if sp else [])


_COMPILED = {}


def pallas_pass(use_lstm, NL, sp, case):
    """The TPU kernels' forward (saves on) and backward in interpret mode,
    compiled once per (cell, depth, SimpleProjection): logits and the
    backward's outputs (input gradients, weight gradients in the
    reference's order, d(hf), d(enc))."""
    mod = dtp if use_lstm else dtgp
    tm = lambda a: jnp.asarray(a).transpose(1, 0, 2)  # noqa: E731
    args = (jax_weights(case["weights"], use_lstm, NL, sp), tm(case["hf"]),
            tm(case["enc"]), jnp.asarray(case["amask"].T),
            [jnp.asarray(a) for a in case["x"]], jnp.asarray(case["gum"]),
            jnp.asarray(case["flag"][:, :, None]), jnp.asarray(case["lm"]),
            tuple(jnp.asarray(m) for m in case["inter"]),
            jnp.asarray(case["dlog"]))

    def run(weights, hf, enc, amask, x, gum, flag, lm, inter, dlog):
        dims = mod._seq_dims(weights, enc, sp)
        outs = mod._fwd_call(weights, hf, enc, amask, *x, gum, flag, lm,
                             inter, dims=dims, sp=sp, bf16=False, save=True)
        grads = mod._bwd_call(weights, hf, enc, amask, *x, gum, flag, lm,
                              inter, tuple(outs), dlog, dims=dims, sp=sp,
                              bf16=False)
        return outs[0], grads

    key = (use_lstm, NL, sp)
    if key not in _COMPILED:
        _COMPILED[key] = quick_jit(run, *args)
    return _COMPILED[key](*args)


def port_grads_from_jax(grads, use_lstm, NL, sp):
    """The reference backward's weight gradients in the port's order and
    shapes (each LSTM layer's kernel whole, biases flat)."""
    g = [np.asarray(a) for a in grads]
    if use_lstm:
        out = g[:4] + [np.concatenate([g[4], g[6]]), g[5]] + g[7:14]
        for layer in range(NL - 1):
            i = 14 + 3 * layer
            out += [np.concatenate([g[i], g[i + 2]]), g[i + 1]]
        g = out + (g[-2:] if sp else [])
    return [a[0] if a.ndim == 2 and a.shape[0] == 1 else a for a in g]


KERNEL_CONFIGS = [(True, 1, True), (True, 3, False), (False, 2, True),
                  (False, 3, False)]
VARIANTS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("samp,drop", VARIANTS)
@pytest.mark.parametrize("use_lstm,NL,sp", KERNEL_CONFIGS)
def test_plain_version_matches_the_pallas_kernels(use_lstm, NL, sp, samp,
                                                  drop):
    """The plain version and its autograd equal the TPU kernels' forward
    and backward: logits, every weight gradient and those of hf, enc and
    the LM cell's precomputed input rows."""
    case = kernel_case(use_lstm, NL, sp, seed=NL * 10 + int(sp))
    if not samp:
        case["flag"] = np.zeros_like(case["flag"])
    if not drop:
        case["lm"] = np.ones_like(case["lm"])
        case["inter"] = np.ones_like(case["inter"])
    want_logits, want = pallas_pass(use_lstm, NL, sp, case)
    n_x = len(case["x"])
    n_w = len(case["weights"])
    t = lambda a: torch.tensor(a, requires_grad=True)  # noqa: E731
    weights = [t(a) for a in case["weights"]]
    hf, enc, x = t(case["hf"]), t(case["enc"]), [t(a) for a in case["x"]]
    ref = (dec_train.dec_train if use_lstm else dec_train_gru.dec_train_gru)
    logits = ref(weights, hf, enc, torch.tensor(case["amask"]), *x,
                 torch.tensor(case["gum"]) if samp else None,
                 torch.tensor(case["flag"]) if samp else None,
                 torch.tensor(case["lm"]) if drop else None,
                 torch.tensor(case["inter"]) if drop and NL > 1 else None,
                 sp=sp)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=0, atol=1e-5)
    torch.sum(logits * torch.tensor(case["dlog"])).backward()
    got = {f"w{i}": (np.zeros(w.shape, np.float32) if w.grad is None
                     else w.grad.numpy()) for i, w in enumerate(weights)}
    got.update(hf=hf.grad.numpy(), enc=enc.grad.numpy())
    got.update({f"x{i}": a.grad.numpy() for i, a in enumerate(x)})
    jw = port_grads_from_jax(want[n_x:n_x + len(jax_weights(
        case["weights"], use_lstm, NL, sp))], use_lstm, NL, sp)
    assert len(jw) == n_w
    expect = {f"w{i}": a for i, a in enumerate(jw)}
    expect.update(hf=np.asarray(want[-2]).transpose(1, 0, 2),
                  enc=np.asarray(want[-1]).transpose(1, 0, 2))
    expect.update({f"x{i}": np.asarray(want[i]) for i in range(n_x)})
    assert_leaves_close(got, expect)


def _decoder_params(use_lstm, NL, sp, ind, seed=0):
    cfg = DecoderConfig(hidden_size_dec=D, num_layers_dec=NL, emb_size=M,
                        vocab_size=VK, attention_vec_size=A,
                        lm_hidden_size=G_SP if sp else D, ind_softmax=ind,
                        use_lstm=use_lstm, samp_prob=0.5, out_prob_dec=0.7)
    return cfg, attn_decoder.init(torch.Generator().manual_seed(seed), cfg,
                                  E, device="cpu")


@pytest.mark.parametrize("ind", [False, True])
@pytest.mark.parametrize("NL", [1, 2, 3])
@pytest.mark.parametrize("use_lstm", [True, False])
def test_weight_args_match_the_reference(use_lstm, NL, ind):
    """weight_args lays a decoder's weights out as the reference's
    _weight_args (SimpleProjection at depths 2 and 3, ind_softmax's own
    output projection where set)."""
    sp = NL > 1
    cfg, params = _decoder_params(use_lstm, NL, sp, ind)
    assert ("output_proj_ind" in params) == ind
    mod = dec_train if use_lstm else dec_train_gru
    got = [a.numpy() for a in mod.weight_args(params, M)]
    jparams = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a.numpy()), params)
    want = (dtp if use_lstm else dtgp)._weight_args(jparams)
    regrouped = jax_weights(got, use_lstm, NL, sp)
    assert len(regrouped) == len(want)
    for g, w in zip(regrouped, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("ind", [False, True])
@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("NL", [1, 2, 3])
@pytest.mark.parametrize("use_lstm", [True, False])
def test_fused_form_matches_the_scan(use_lstm, NL, sp, ind):
    """apply_train_fused (the kernels' plain versions) equals the plain
    scan over attn_decoder.step, logits and every gradient, for each of
    sampling and dropout on and off, on the same noise."""
    cfg, params = _decoder_params(use_lstm, NL, sp, ind, seed=NL)
    rng = np.random.default_rng(NL)
    ids = torch.tensor(rng.integers(3, VK, size=(L, NB)))
    ids[0] = 1
    enc = torch.tensor(rng.normal(size=(NB, T, E)).astype(np.float32))
    lens = torch.tensor([T, 4, 2])
    noise = attn_decoder.train_noise(torch.Generator().manual_seed(NL), cfg,
                                     L - 1, NB, "cpu")
    assert len(noise[3]) == NL - 1
    fused = dec_train if use_lstm else dec_train_gru
    for samp, drop in VARIANTS:
        c = dataclasses.replace(cfg, samp_prob=0.5 if samp else 0.0,
                                out_prob_dec=0.7 if drop else 1.0)
        flags, gumbel, lm_masks, inter = noise
        if not samp:
            flags = gumbel = None
        if not drop:
            lm_masks, inter = None, ()
        results = []
        for form in ("scan", "fused"):
            leaves = {k: v.detach().requires_grad_(True) for k, v in
                      checkpoint.flatten_named(params).items()}
            p = checkpoint._fill(params, leaves)
            if form == "scan":
                out = attn_decoder.apply_train(p, c, ids, enc, lens,
                                               noise=noise)
            else:
                out = fused.apply_train_fused(
                    p, c, p["embedding"][ids.long()], enc, lens, flags,
                    gumbel, lm_masks, inter)
            torch.sum(out * torch.linspace(-1, 1, out.numel()).reshape(
                out.shape)).backward()
            results.append((out.detach().numpy(),
                            {k: v.grad.numpy() if v.grad is not None else
                             np.zeros(v.shape, np.float32)
                             for k, v in leaves.items()}))
        (scan_out, scan_g), (fused_out, fused_g) = results
        np.testing.assert_allclose(fused_out, scan_out, rtol=0, atol=1e-5)
        assert_leaves_close(fused_g, scan_g)


@pytest.fixture(scope="module")
def apply_train_case():
    """JAX's apply_train of a 2-layer LSTM char decoder with
    SimpleProjection and ind_softmax (its fused path: the TPU kernels in
    interpret mode): logits and gradients of their weighted sum, and its
    noise."""
    cfg = deep_cfg()
    dcfg = cfg.decoders["char"]
    jparams, named = init_both(cfg, 5)
    rng = np.random.default_rng(2)
    enc = rng.normal(size=(B, 7, 16)).astype(np.float32)
    enc_lens = np.array([7, 4, 2], np.int32)
    ids = make_batch(4)["char"].T
    w = rng.normal(size=(L - 1, B, V)).astype(np.float32)
    key = jax.random.PRNGKey(11)

    def jloss(p, e):
        out = jdec.apply_train(p, dcfg, jnp.asarray(ids), e,
                               jnp.asarray(enc_lens), rng=key)
        return jnp.sum(out * w), out

    args = (jparams["decoder_char"], jnp.asarray(enc))
    (_, logits), (gp, ge) = quick_jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True), *args)(*args)
    noise = jdec.train_noise(key, dcfg, L - 1, B)
    assert float(noise[0].sum()) > 0 and len(noise[3]) == 1
    return (cfg, named, enc, enc_lens, ids, w, noise, logits,
            jckpt.flatten_named(gp), ge)


@pytest.mark.parametrize("form", ["scan", "fused"])
def test_apply_train_matches_jax(apply_train_case, form):
    (cfg, named, enc, enc_lens, ids, w, noise, want, want_gp,
     want_ge) = apply_train_case
    dcfg = cfg.decoders["char"]
    flags, gumbel, lm_masks = (torch.tensor(np.asarray(a))
                               for a in noise[:3])
    inter = tuple(torch.tensor(np.asarray(m)) for m in noise[3])
    params = checkpoint.params_from_named(named, cfg, "cpu")["decoder_char"]
    assert {"simple_proj", "output_proj_ind"} <= set(params)
    assert len(params["dec_cells"]) == 2
    leaves = {k: v.requires_grad_(True)
              for k, v in checkpoint.flatten_named(params).items()}
    e = torch.tensor(enc, requires_grad=True)
    lens = torch.tensor(enc_lens)
    if form == "scan":
        logits = attn_decoder.apply_train(
            params, dcfg, torch.tensor(ids), e, lens,
            noise=(flags, gumbel, lm_masks, inter))
    else:
        emb_in = params["embedding"][torch.tensor(ids).long()]
        logits = dec_train.apply_train_fused(params, dcfg, emb_in, e, lens,
                                             flags, gumbel, lm_masks, inter)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    torch.sum(logits * torch.tensor(w)).backward()
    got = {k: (v.grad.numpy() if v.grad is not None
               else np.zeros(v.shape, np.float32)) for k, v in leaves.items()}
    assert_leaves_close(got, want_gp)
    assert_leaves_close({"enc": e.grad.numpy()}, {"enc": want_ge})


def test_fused_form_applies_the_inter_layer_masks(monkeypatch):
    """The fused form hands the inter-layer dropout masks to the kernel's
    plain version, which applies them: a zero mask between the layers
    changes the logits, an all-one mask equals no mask."""
    cfg, params = _decoder_params(True, 2, True, False, seed=4)
    cfg = dataclasses.replace(cfg, samp_prob=0.0)
    rng = np.random.default_rng(4)
    ids = torch.tensor(rng.integers(3, VK, size=(L, NB)))
    enc = torch.tensor(rng.normal(size=(NB, T, E)).astype(np.float32))
    lens = torch.tensor([T, 4, 2])
    seen = []
    real = dec_train.dec_train_reference
    monkeypatch.setattr(dec_train, "dec_train_reference",
                        lambda *a, **kw: seen.append(a[8]) or real(*a, **kw))
    lm = torch.ones(L - 1, NB, G_SP)

    def run(inter):
        return dec_train.apply_train_fused(
            params, cfg, params["embedding"][ids.long()], enc, lens, None,
            None, lm, inter).detach()

    ones = run((torch.ones(L - 1, NB, D),))
    zeros = run((torch.zeros(L - 1, NB, D),))
    assert seen[0].shape == (1, L - 1, NB, D) and float(seen[1].sum()) == 0
    torch.testing.assert_close(run(()), ones, atol=0, rtol=0)
    assert float((ones - zeros).abs().max()) > 1e-3
    scan = attn_decoder.apply_train(
        params, cfg, ids, enc, lens,
        noise=(None, None, lm, (torch.zeros(L - 1, NB, D),)))
    torch.testing.assert_close(zeros, scan.detach(), atol=1e-5, rtol=0)


def test_deep_asr_step_matches_jax():
    """One asr_step of the deep char + phone model, all noise on: loss,
    task losses and every gradient leaf against JAX's value_and_grad, and
    the params after clip + Adam against optax's."""
    cfg = deep_cfg()
    jparams, named = init_both(cfg, 3)
    batch = make_batch(5)
    key = jax.random.PRNGKey(7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    lm_cfg = LMConfig(vocab_size=V)
    jstate = jax.jit(lambda p: jstep.create_state(p, cfg, lm_cfg))(jparams)
    opt = jstep.make_optimizer(cfg.learning_rate, cfg.max_gradient_norm)

    def jax_step(p, opt_state):
        (loss, tasks), grads = jax.value_and_grad(
            lambda q: jseq2seq.apply_train(q, cfg, jbatch, rng=key),
            has_aux=True)(p)
        updates, _ = opt.update(grads, opt_state, p)
        return (loss, tasks, grads, optax.apply_updates(p, updates),
                draw_jax_noise(cfg, key, jbatch))

    args = (jstate.params, jstate.opt_state)
    jloss, jtasks, jgrads, jnew, drawn = quick_jit(jax_step, *args)(*args)
    assert len(drawn[1][0][3]) == 1           # the char decoder's mask
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
    jg = jckpt.flatten_named(jgrads)
    assert any("dec_cells/1" in k for k in jg) and any(
        "simple_proj" in k for k in jg)
    assert_leaves_close({k: v / (1 - step.B1) for k, v in mu.items()}, jg)
    got = checkpoint.named_from_params(new_state.params)
    want = jckpt.flatten_named(jnew)
    for name, g in jg.items():
        big = np.abs(g) > max(1e-2 * np.abs(g).max(), 1e-6)
        np.testing.assert_allclose(got[name][big], np.asarray(want[name])[big],
                                   rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("use_lstm", [True, False])
def test_deep_checkpoint_decodes_as_in_jax(tmp_path, use_lstm):
    """A deep checkpoint written by JAX (the LSTM model, and the -gru one)
    loads in the port (`load_npz`, strict), gives back the same named
    leaves, and decodes as in JAX: greedy, and beam by either route (#15
    at 2 rows, per-step at 3)."""
    cfg = deep_cfg(use_lstm=use_lstm)
    jparams, _ = init_both(cfg, 6)
    out = dict(jparams["decoder_char"]["output_proj_ind"])
    out["bias"] = out["bias"].at[2].add(0.5)      # some rows finish early
    jparams["decoder_char"]["output_proj_ind"] = out
    lm_cfg = LMConfig(vocab_size=V)
    jpath = jckpt.save(str(tmp_path), "asr.ckpt", 1,
                       jstep.create_state(jparams, cfg, lm_cfg))
    params = checkpoint.load_npz(jpath, cfg, "cpu")
    back = checkpoint.named_from_params(params)     # and the other way
    want = jckpt.flatten_named(jparams)
    assert sorted(back) == sorted(want)
    for name, leaf in want.items():
        np.testing.assert_array_equal(back[name], np.asarray(leaf), name)
    assert {"decoder_char/dec_cells/1/kernel" if use_lstm else
            "decoder_char/dec_cells/1/gates/kernel",
            "decoder_char/simple_proj/kernel",
            "decoder_char/output_proj_ind/kernel",
            "decoder_phone/simple_proj/bias"} <= set(back)
    batch = make_batch(6)
    feats, lens = (jnp.asarray(batch["logmel"]),
                   jnp.asarray(batch["logmel_len"]))
    bc = dict(beam_size=3, max_steps=8)

    def jax_decodes(p, f, n):
        states, _, enc_lens = jseq2seq.encode(p, cfg, f, n)
        return (jseq2seq.apply_greedy(p, cfg, f, n, task="char"),
                jbeam.beam_decode(p["decoder_char"], cfg.decoders["char"],
                                  JBeamConfig(**bc), states[2], enc_lens[2]))

    want_greedy, want_beam = quick_jit(jax_decodes, jparams, feats, lens)(
        jparams, feats, lens)
    got = seq2seq.apply_greedy(params, cfg, torch.tensor(batch["logmel"]),
                               torch.tensor(batch["logmel_len"]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_greedy))
    states, _, enc_lens = seq2seq.encode(params, cfg,
                                         torch.tensor(batch["logmel"]),
                                         torch.tensor(batch["logmel_len"]))
    for route in (beam.beam_decode, beam.beam_decode_steps):
        for rows in (slice(0, 2), slice(0, 3)):
            _assert_same(route(params["decoder_char"], cfg.decoders["char"],
                               BeamConfig(**bc), states[2][rows],
                               enc_lens[2][rows]),
                         [np.asarray(x)[rows] for x in want_beam])


@pytest.mark.parametrize("gru", [False, True])
def test_cli_deep_decoder_trains_and_evaluates(workspace, capsys,  # noqa
                                               gru):
    """cli.main with a 2-layer char decoder, an LM cell wider than the
    decoder (SimpleProjection) and ind_softmax, LSTM and -gru: the run
    directory takes the JAX command's char_dec_dep_2_ name and
    parameters.txt its bytes; it trains two steps and decodes the dev
    set by beam."""
    argv = _args(workspace)
    for flag in ("-lm_hsize", "-run_id"):     # set below
        i = argv.index(flag)
        argv = argv[:i] + argv[i + 2:]
    argv += ["-num_layers_dec", "2", "-lm_hsize", "12", "-ind_softmax",
             "-run_id", "7" if gru else "6"] + (["-gru"] if gru else [])
    want = jmain.parse_options(argv)
    train_dir = want.train.train_dir
    assert "char_dec_dep_2_" in os.path.basename(train_dir)
    with open(os.path.join(train_dir, "parameters.txt"), "rb") as f:
        jax_text = f.read()
    main.main(argv)
    with open(os.path.join(train_dir, "parameters.txt"), "rb") as f:
        assert f.read() == jax_text
    assert "asr.ckpt-2.npz" in os.listdir(train_dir)
    named = checkpoint.load_named(os.path.join(train_dir, "asr.ckpt-2.npz"))
    assert any("decoder_char/dec_cells/1" in k for k in named)
    capsys.readouterr()
    main.main(argv + ["-dev", "-beam_size", "2"])
    out = capsys.readouterr().out
    assert f"Using the model from: {train_dir}/asr.ckpt-2.npz" in out
    assert "Score:" in out
