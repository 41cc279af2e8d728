"""Port parity for the transformer encoder family on the CPU, where kernel
#18's wrapper runs its plain version, against the JAX package.

- #18: `attend_reference` (the plain version) and the autograd form
  `attend` against `mhsa_pallas._fwd` / `attend` in interpret mode, with
  and without relmat, one batch item of zero length in each case: out,
  probs, and the VJP of q, k, v and relmat;
- the layer norm, the tanh GELU, the interleaved sinusoids, the clamped
  relative-position bias and the conv module (kernel 3 and 4: odd and even
  SAME padding) against the JAX package's;
- `transformer_encoder.apply` per depth (plain, rel-bias, conv 3, conv 4
  with rel-bias), padding invariance, the gate on the CPU; init names both
  ways for every variant and family;
- one char + phone `asr_step` with JAX's dropout bits against
  value_and_grad and optax; greedy and beam decodes (both routes) and a CTC
  loss on a transformer encoder against JAX; serving and the command line;
- the raises: MoE, attn_chunk, remat; 'Wide layers' above H = 1024.

Sizes: B = 3, 64 frames -> T' = 8 after the 8x subsample, D = 32 (hd 8,
4 heads), 2 blocks. JAX runs its XLA path (tests/conftest.py), compiled
once per fixture. Tolerances (float32, sums in other orders): forward
values 1e-5 absolute, gradients 1e-4 relative to each leaf's largest value,
the step's loss 1e-5 relative and its params 1e-6 where the gradient is
large; decodes exactly.
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
from e2e_asr_tpu.models import ctc as jctc
from e2e_asr_tpu.models import encoder as jencoder
from e2e_asr_tpu.models import seq2seq as jseq2seq
from e2e_asr_tpu.models import transformer_encoder as jxfmr
from e2e_asr_tpu.ops import mhsa_pallas
from e2e_asr_tpu.train import step as jstep
from e2e_asr_tpu_torch.cli import main
from e2e_asr_tpu_torch.config import (BeamConfig, DecoderConfig,
                                      EncoderConfig, Seq2SeqConfig)
from e2e_asr_tpu_torch.core import checkpoint, layers
from e2e_asr_tpu_torch.eval import beam, serving
from e2e_asr_tpu_torch.kernels import gru_seq, lstm_bidir, mhsa
from e2e_asr_tpu_torch.models import ctc, encoder, seq2seq
from e2e_asr_tpu_torch.models import transformer_encoder as xfmr
from e2e_asr_tpu_torch.train import step
from tests.test_torch_beam_mega import _assert_same
from tests.test_torch_cli import _args, workspace  # noqa: F401
from tests.test_torch_train_step import assert_leaves_close, quick_jit

torch.set_num_threads(1)
B, T, FEAT, L, LP, V, VP = 3, 64, 5, 6, 5, 9, 7
LENS = [64, 41, 7]                      # -> 8, 6, 1 frames after the 8x
NUM_LAYERS = {"char": 2, "phone": 1, "state": 2}
VARIANTS = {"plain": {}, "rel": dict(rel_pos_bias=True),
            "conv3": dict(conv_kernel=3),
            "conv4_rel": dict(conv_kernel=4, rel_pos_bias=True)}


def xfmr_cfg(tasks=("char", "phone"), **enc_kw) -> Seq2SeqConfig:
    def dec(vocab):
        return DecoderConfig(hidden_size_dec=8, emb_size=8, vocab_size=vocab,
                             attention_vec_size=6, lm_hidden_size=8,
                             samp_prob=0.5, out_prob_dec=0.7, max_output=8)

    vocab = {"char": V, "phone": VP}
    return Seq2SeqConfig(
        tasks=list(tasks), num_layers={"char": 2, "phone": 1},
        max_output={t: 8 for t in tasks},
        encoder=EncoderConfig(hidden_size=16, encoder_type="transformer",
                              num_heads=4, ffn_mult=2, subsample=8,
                              out_prob=0.8, **enc_kw),
        decoders={t: dec(vocab[t]) for t in tasks}, avg=True,
        feat_length=FEAT)


def make_batch(seed: int, lens=LENS) -> dict:
    rng = np.random.default_rng(seed)
    x = np.zeros((B, T, FEAT), np.float32)
    for i, n in enumerate(lens):
        x[i, :n] = rng.normal(size=(n, FEAT))
    batch = {"logmel": x, "logmel_len": np.array(lens, np.int32)}
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


def carried(cfg, seed: int):
    """The port's init of cfg by name, every rel-bias table filled with
    numpy noise (its init is zeros), and JAX's pytree of the same leaves
    (laid out by jax.eval_shape of the JAX init, so nothing compiles)."""
    named = checkpoint.named_from_params(step.init_params(
        torch.Generator().manual_seed(seed), cfg, device="cpu"))
    rng = np.random.default_rng(seed)
    for k in named:
        if k.endswith("rel_bias"):
            named[k] = (rng.normal(size=named[k].shape) * 0.5).astype(
                np.float32)
    shapes = jax.eval_shape(lambda: jstep.init_params(jax.random.PRNGKey(0),
                                                      cfg))
    return named, jax.tree_util.tree_map(
        jnp.asarray, jckpt.unflatten_named(shapes, named))


def t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


# --------------------------------------------------------------- kernel #18

# (B, nh, T, hd, relmat): batch item 1 has zero length in each case.
CASES = [(3, 4, 8, 8, False), (3, 4, 8, 8, True), (2, 2, 13, 4, False),
         (2, 2, 13, 4, True)]


def kernel_case(Bk, nh, Tk, hd, rel, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(Bk, nh, Tk, hd)).astype(np.float32)
                  for _ in range(4))
    lens = rng.integers(1, Tk + 1, size=Bk)
    lens[1] = 0
    pad = np.where(np.arange(Tk)[None, :] < lens[:, None], 0.0,
                   -1e30).astype(np.float32)
    relmat = ((rng.normal(size=(nh, Tk, Tk)) * 0.3).astype(np.float32)
              if rel else np.zeros((nh, Tk, Tk), np.float32))
    return q, k, v, pad, relmat, g


@pytest.fixture(scope="module")
def kernel_jax():
    """For every case, the Pallas kernel's (out, probs) in interpret mode
    and the VJP of its custom-VJP entry, in one compile."""
    cases = [kernel_case(*c) for c in CASES]

    def run(cases):
        res = []
        for q, k, v, pad, relmat, g in cases:
            out, probs = mhsa_pallas._fwd(q, k, v, pad, relmat, False)
            _, vjp = jax.vjp(lambda a, b, c, r: mhsa_pallas.attend(
                a, b, c, pad, r, False), q, k, v, relmat)
            res.append((out, probs, vjp(g)))
        return res

    args = jax.tree_util.tree_map(jnp.asarray, cases)
    return cases, quick_jit(run, args)(args)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_version_matches_the_pallas_kernel(kernel_jax, case):
    cases, want = kernel_jax
    q, k, v, pad, relmat, _ = (t(a) for a in cases[case])
    out, probs = mhsa.attend(q, k, v, pad, relmat, return_probs=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want[case][0]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(probs.numpy(), np.asarray(want[case][1]),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_autograd_form_matches_the_pallas_vjp(kernel_jax, case):
    """dq, dk, dv and drel through `_Attend` (the saved-probs backward)
    against JAX's custom VJP, the zero-length row included."""
    cases, want = kernel_jax
    q, k, v, pad, relmat, g = (t(a) for a in cases[case])
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, relmat)]
    out = mhsa.attend(leaves[0], leaves[1], leaves[2], pad, leaves[3])
    grads = torch.autograd.grad(out, leaves, g)
    for name, got, w in zip("qkvr", grads, want[case][2]):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_out_is_the_same_with_and_without_probs(case):
    """`attend` without return_probs (the out-only form on the card) gives
    the out of return_probs, on the CPU's plain version, launching
    nothing."""
    q, k, v, pad, relmat, _ = (t(a) for a in kernel_case(*CASES[case]))
    before = mhsa.LAUNCHES, mhsa.PROBS_LAUNCHES
    out, _ = mhsa.attend(q, k, v, pad, relmat, return_probs=True)
    assert torch.equal(mhsa.attend(q, k, v, pad, relmat), out)
    assert (mhsa.LAUNCHES, mhsa.PROBS_LAUNCHES) == before


@pytest.mark.parametrize("values,route", [((1, 16, 64, 80128), "onchip"),
                                          ((1, 64, 64, 100864), "onchip"),
                                          ((0, 32, 64, 33792), "chunked")])
def test_plan_reader_parses_a_plan(values, route):
    """mhsa.plan's reader of what e2e_mhsa_plan writes."""
    assert mhsa.parse_plan(values) == {"route": route, "rows": values[1],
                                       "keys": 64, "smem": values[3]}


def test_zero_length_row_is_uniform():
    q, k, v, pad, relmat, _ = (t(a) for a in kernel_case(3, 4, 8, 8, True))
    out, probs = mhsa.attend(q, k, v, pad, relmat, return_probs=True)
    torch.testing.assert_close(probs[1], torch.full_like(probs[1], 1 / 8),
                               rtol=0, atol=1e-7)
    torch.testing.assert_close(out[1], v[1].mean(1, keepdim=True).expand(
        -1, 8, -1), rtol=0, atol=1e-5)


def test_reference_without_relmat_matches_replay():
    q, k, v, pad, _, _ = kernel_case(2, 2, 13, 4, False, seed=3)
    want = jax.jit(lambda *a: mhsa_pallas._replay(*a, None, False))(
        q, k, v, pad)
    got, _ = mhsa.attend_reference(t(q), t(k), t(v), t(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_cpu_tensors_launch_nothing_and_pad_bias_gets_zeros():
    q, k, v, pad, relmat, g = (t(a) for a in kernel_case(3, 4, 8, 8, True))
    before = mhsa.LAUNCHES
    pad = pad.clone().requires_grad_(True)
    out = mhsa.attend(q, k, v, pad, relmat)
    (dpad,) = torch.autograd.grad(out, [pad], g)
    assert mhsa.LAUNCHES == before
    assert torch.equal(dpad, torch.zeros_like(pad))


def test_bf16_raises():
    q, k, v, pad, relmat, _ = (t(a) for a in kernel_case(3, 4, 8, 8, False))
    with pytest.raises(NotImplementedError, match="Decode features"):
        mhsa.attend(q, k, v, pad, relmat, bf16=True)


def test_gate_is_read_at_each_call(monkeypatch):
    monkeypatch.delenv("E2E_ASR_MHSA_KERNEL", raising=False)
    assert not mhsa.enabled() and not mhsa_pallas.enabled()
    monkeypatch.setenv("E2E_ASR_MHSA_KERNEL", "1")
    assert mhsa.enabled() and mhsa_pallas.enabled()


@pytest.mark.parametrize("hd", [6, 260])
def test_kernel_limits_raise_before_any_launch(hd):
    """Head widths the kernel does not take raise ValueError in its checks
    (on meta tensors: nothing is allocated or launched)."""
    q = torch.empty(2, 2, 5, hd, device="meta")
    with pytest.raises(ValueError, match="head width"):
        mhsa._check(q, q, q, torch.empty(2, 5, device="meta"),
                    torch.empty(2, 5, 5, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        mhsa.attend(q, q, q, torch.empty(2, 5, device="meta"),
                    torch.empty(2, 5, 5, device="meta"))


# ---------------------------------------------------------------- layers

@pytest.fixture(scope="module")
def layers_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, 8, 32)).astype(np.float32) * 2 + 0.5
    norm = {"scale": rng.normal(size=32).astype(np.float32),
            "bias": rng.normal(size=32).astype(np.float32)}
    table = rng.normal(size=(4, 127)).astype(np.float32)
    vmask = (np.arange(8)[None, :] < np.array([8, 6, 1])[:, None]).astype(
        np.float32)[:, :, None]
    convs = {}
    for kk in (3, 4):
        convs[kk] = {
            "ln": norm, "ln2": {"scale": norm["bias"], "bias": norm["scale"]},
            "pw1": {"kernel": rng.normal(size=(32, 64)).astype(np.float32)
                    * 0.2, "bias": rng.normal(size=64).astype(np.float32)},
            "dw": rng.normal(size=(kk, 32)).astype(np.float32),
            "pw2": {"kernel": rng.normal(size=(32, 32)).astype(np.float32)
                    * 0.2, "bias": rng.normal(size=32).astype(np.float32)}}
    inputs = (x, norm, table, vmask, convs)

    def run(x, norm, table, vmask, convs):
        return (jxfmr._layer_norm(norm, x), jax.nn.gelu(x),
                jxfmr._sinusoidal_at(jnp.arange(70), 32),
                jxfmr._rel_bias(table, 70)[0],
                {kk: jxfmr._conv_module(p, x, vmask)
                 for kk, p in convs.items()})

    args = jax.tree_util.tree_map(jnp.asarray, inputs)
    return inputs, quick_jit(run, *args)(*args)


def test_layer_norm_matches_jax(layers_jax):
    (x, norm, *_), (want, *_) = layers_jax
    got = layers.layer_norm({k: t(v) for k, v in norm.items()}, t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_gelu_is_jax_tanh_form(layers_jax):
    (x, *_), (_, want, *_) = layers_jax
    got = layers.gelu(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    erf = torch.nn.functional.gelu(t(x))
    assert float((erf - got).abs().max()) > 1e-5    # not the default form


def test_sinusoids_interleave_as_jax(layers_jax):
    want = np.asarray(layers_jax[1][2])
    got = xfmr._sinusoidal_at(torch.arange(70), 32).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[:, 1::2][0], 1.0)     # cos(0) odd slots


def test_rel_bias_clamps_as_jax(layers_jax):
    (_, _, table, *_), (*_, want, _) = layers_jax
    got = xfmr._rel_bias(t(table), 70)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got[:, 69, 0], got[:, 69, 5])     # beyond +-63


@pytest.mark.parametrize("kk", [3, 4])
def test_conv_module_pads_as_xla_same(layers_jax, kk):
    (x, _, _, vmask, convs), (*_, want) = layers_jax
    p = jax.tree_util.tree_map(t, convs[kk])
    got = xfmr._conv_module(p, t(x), t(vmask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want[kk]), rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------- encoder

@pytest.fixture(scope="module")
def encoder_jax():
    """Each variant's weights, and JAX's encoder outputs per depth on a
    batch and on the same batch with 24 more padding frames, one
    compile."""
    models = {name: carried(xfmr_cfg(**kw), 10 + i)
              for i, (name, kw) in enumerate(VARIANTS.items())}
    batch = make_batch(11)
    padded = np.pad(batch["logmel"], ((0, 0), (0, 24), (0, 0)))

    def run(jparams, x, xp, lens):
        out = {}
        for name, kw in VARIANTS.items():
            ecfg = xfmr_cfg(**kw).encoder
            p = jparams[name]["encoder"]
            out[name] = (jencoder.apply(p, ecfg, x, lens, NUM_LAYERS),
                         jencoder.apply(p, ecfg, xp, lens, NUM_LAYERS)[0])
        return out

    args = ({n: m[1] for n, m in models.items()},
            jnp.asarray(batch["logmel"]), jnp.asarray(padded),
            jnp.asarray(batch["logmel_len"]))
    return models, batch, padded, quick_jit(run, *args)(*args)


def port_encode(named, cfg, x, lens):
    params = checkpoint.params_from_named(named, cfg, "cpu")
    return encoder.apply(params["encoder"], cfg.encoder, t(x), t(lens),
                         NUM_LAYERS)


@pytest.mark.parametrize("variant", VARIANTS)
def test_apply_matches_jax_per_depth(encoder_jax, variant):
    models, batch, _, want = encoder_jax
    cfg = xfmr_cfg(**VARIANTS[variant])
    attn, tm, lens = port_encode(models[variant][0], cfg, batch["logmel"],
                                 batch["logmel_len"])
    (jattn, jtm, jlens), _ = want[variant]
    assert sorted(attn) == sorted(jattn) == [1, 2] and list(tm) == [2]
    for d in attn:
        np.testing.assert_allclose(attn[d].numpy(), np.asarray(jattn[d]),
                                   rtol=0, atol=1e-5, err_msg=str(d))
        np.testing.assert_array_equal(lens[d].numpy(), np.asarray(jlens[d]))
    np.testing.assert_allclose(tm[2].numpy(), np.asarray(jtm[2]), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(lens[2].numpy(), [8, 6, 1])
    assert not attn[2][1, 6:].any() and not attn[2][2, 1:].any()


@pytest.mark.parametrize("variant", ["plain", "conv4_rel"])
def test_padding_frames_change_nothing(encoder_jax, variant):
    """24 more padding frames (3 more after the subsample) leave every
    valid output as it was, here and in JAX."""
    models, batch, padded, want = encoder_jax
    cfg = xfmr_cfg(**VARIANTS[variant])
    attn, _, _ = port_encode(models[variant][0], cfg, padded,
                             batch["logmel_len"])
    jpad = want[variant][1]
    for d, n in ((1, 8), (2, 8)):
        np.testing.assert_allclose(attn[d][:, :n].numpy(),
                                   np.asarray(want[variant][0][0][d]),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(attn[d].numpy(), np.asarray(jpad[d]),
                                   rtol=0, atol=1e-5)


def test_gate_on_the_cpu_runs_the_plain_version(encoder_jax, monkeypatch):
    """With E2E_ASR_MHSA_KERNEL set, inference goes through mhsa.attend
    (its plain version on the CPU: no launch) and gives the same states."""
    models, batch, _, want = encoder_jax
    calls = []
    real = mhsa.attend
    monkeypatch.setattr(mhsa, "attend",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setenv("E2E_ASR_MHSA_KERNEL", "1")
    before = mhsa.LAUNCHES
    with torch.no_grad():
        attn, _, _ = port_encode(models["conv4_rel"][0],
                                 xfmr_cfg(**VARIANTS["conv4_rel"]),
                                 batch["logmel"], batch["logmel_len"])
    assert len(calls) == 2 and mhsa.LAUNCHES == before
    np.testing.assert_allclose(attn[2].numpy(),
                               np.asarray(want["conv4_rel"][0][0][2]),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("variant", VARIANTS)
def test_init_names_match_jax(variant):
    cfg = xfmr_cfg(**VARIANTS[variant])
    named = checkpoint.named_from_params(seq2seq.init(
        torch.Generator().manual_seed(0), cfg, device="cpu"))
    shapes = jax.eval_shape(lambda: jseq2seq.init(jax.random.PRNGKey(0),
                                                  cfg))
    assert sorted(named) == sorted(jckpt.flatten_named(shapes))
    jckpt.unflatten_named(shapes, named)                # strict, shapes
    assert ("encoder/block_2/rel_bias" in named) == ("rel" in variant)
    assert ("encoder/block_1/conv/dw" in named) == ("conv" in variant)
    checkpoint.params_from_named(named, cfg, "cpu")     # strict


@pytest.mark.parametrize("family", ["ctc", "hybrid", "transducer"])
def test_other_families_build_on_a_transformer(family):
    base = xfmr_cfg(tasks=("char",))
    cfg = {"ctc": dataclasses.replace(base, model_family="ctc"),
           "hybrid": dataclasses.replace(base, ctc_weight=0.3),
           "transducer": dataclasses.replace(
               base, model_family="transducer", decoders={
                   "char": dataclasses.replace(base.decoders["char"],
                                               joint_dim=8)})}[family]
    named = checkpoint.named_from_params(step.init_params(
        torch.Generator().manual_seed(0), cfg, device="cpu"))
    shapes = jax.eval_shape(lambda: jstep.init_params(jax.random.PRNGKey(0),
                                                      cfg))
    assert sorted(named) == sorted(jckpt.flatten_named(shapes))
    assert "encoder/block_2/qkv/kernel" in named


# ------------------------------------------------------------- training

def draw_jax_noise(cfg, key, batch):
    """JAX's noise for seq2seq.apply_train(rng=key) with a transformer
    encoder (seq2seq.py:81, transformer_encoder.py:693-696): block i's
    three keep-masks from fold_in(rng_enc, 3i + j), and each task's decoder
    noise."""
    rng_enc, rng_dec = jax.random.split(key)
    Tp = -(-batch["logmel"].shape[1] // cfg.encoder.subsample)
    D = xfmr.d_model(cfg.encoder)
    enc = [tuple(jax.random.bernoulli(
        jax.random.fold_in(rng_enc, 3 * i + j), cfg.encoder.out_prob,
        (B, Tp, D)) for j in range(3))
        for i in range(1, max(cfg.num_layers.values()) + 1)]
    return enc, [jdec.train_noise(jax.random.fold_in(rng_dec, i),
                                  cfg.decoders[task],
                                  batch[task].shape[1] - 1, B)
                 for i, task in enumerate(cfg.tasks)]


def port_noise(cfg, drawn) -> dict:
    enc, decoders = drawn
    noise = {"encoder": {i + 1: (t(a), t(c) if cfg.encoder.conv_kernel
                                 else None, t(f))
                         for i, (a, c, f) in enumerate(enc)}}
    for task, (flags, gumbel, lm_masks, inter) in zip(cfg.tasks, decoders):
        noise[task] = (t(flags), t(gumbel), t(lm_masks),
                       tuple(t(m) for m in inter))
    return noise


def test_asr_step_matches_jax():
    """One char + phone asr_step on the rel-bias + conv-4 encoder, dropout
    with JAX's bits and scheduled sampling on: loss, task losses and every
    gradient leaf against value_and_grad, params after clip + Adam against
    optax."""
    cfg = xfmr_cfg(**VARIANTS["conv4_rel"])
    named, jparams = carried(cfg, 3)
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
    assert float(np.abs(jg["encoder/block_1/rel_bias"]).max()) > 0
    assert_leaves_close({k: v / (1 - step.B1) for k, v in mu.items()}, jg)
    got = checkpoint.named_from_params(new_state.params)
    want = jckpt.flatten_named(jnew)
    for name, g in jg.items():
        big = np.abs(g) > max(1e-2 * np.abs(g).max(), 1e-6)
        np.testing.assert_allclose(got[name][big], np.asarray(want[name])[big],
                                   rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("conv", [0, 3])
def test_training_draws_its_masks_from_the_generator(conv):
    """Without noise the masks come from `gen`: two equal generators give
    equal states, another seed other ones, and inference draws nothing."""
    cfg = xfmr_cfg(conv_kernel=conv)
    params = seq2seq.init(torch.Generator().manual_seed(1), cfg,
                          device="cpu")["encoder"]
    batch = make_batch(2)
    x, lens = t(batch["logmel"]), t(batch["logmel_len"])

    def run(seed, train=True):
        gen = torch.Generator().manual_seed(seed)
        out = encoder.apply(params, cfg.encoder, x, lens, {"char": 2},
                            train=train, gen=gen)[0][2]
        return out, torch.rand(1, generator=gen)

    a, _ = run(0)
    b, _ = run(0)
    c, _ = run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    _, after = run(0, train=False)
    assert torch.equal(after, torch.rand(
        1, generator=torch.Generator().manual_seed(0)))


# -------------------------------------------------------------- decoding

@pytest.fixture(scope="module")
def decode_jax():
    """A rel-bias + conv-3 model's greedy and beam decodes and a CTC
    model's loss, in JAX, one compile."""
    cfg = xfmr_cfg(tasks=("char",), rel_pos_bias=True, conv_kernel=3)
    named, jparams = carried(cfg, 6)
    out = dict(jparams["decoder_char"]["output_proj"])
    out["bias"] = out["bias"].at[2].add(0.5)        # some rows finish early
    jparams["decoder_char"]["output_proj"] = out
    named["decoder_char/output_proj/bias"] = np.asarray(out["bias"])
    ccfg = dataclasses.replace(cfg, model_family="ctc")
    cnamed, cparams = carried(ccfg, 8)
    batch = make_batch(12)
    labels = np.array([[3, 4, 5], [6, 7, 0], [8, 0, 0]], np.int32)
    label_lens = np.array([3, 2, 1], np.int32)
    bc = dict(beam_size=3, max_steps=8)

    def run(p, cp, f, n, lab, ll):
        states, _, enc_lens = jseq2seq.encode(p, cfg, f, n)
        return (jseq2seq.apply_greedy(p, cfg, f, n, task="char"),
                jbeam.beam_decode(p["decoder_char"], cfg.decoders["char"],
                                  JBeamConfig(**bc), states[2], enc_lens[2]),
                jctc.loss(cp, ccfg, {"logmel": f, "logmel_len": n,
                                     "labels": lab, "label_lens": ll}))

    args = (jparams, cparams, jnp.asarray(batch["logmel"]),
            jnp.asarray(batch["logmel_len"]), jnp.asarray(labels),
            jnp.asarray(label_lens))
    return (cfg, named, ccfg, cnamed, batch, labels, label_lens, bc,
            quick_jit(run, *args)(*args))


def test_greedy_decode_matches_jax(decode_jax):
    cfg, named, *_, batch, _, _, _, (want, _, _) = decode_jax
    params = checkpoint.params_from_named(named, cfg, "cpu")
    got = seq2seq.apply_greedy(params, cfg, t(batch["logmel"]),
                               t(batch["logmel_len"]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("route", ["by_size", "per_step"])
@pytest.mark.parametrize("rows", [2, 3])
def test_beam_decode_matches_jax(decode_jax, monkeypatch, route, rows):
    """Beam 3 by either route (#15's plain version at 2 rows, the
    per-step kernels' at 3), with the #18 gate on: the rows equal JAX's."""
    cfg, named, *_, batch, _, _, bc, (_, want, _) = decode_jax
    monkeypatch.setenv("E2E_ASR_MHSA_KERNEL", "1")
    params = checkpoint.params_from_named(named, cfg, "cpu")
    states, _, enc_lens = seq2seq.encode(params, cfg, t(batch["logmel"]),
                                         t(batch["logmel_len"]))
    fn = beam.beam_decode if route == "by_size" else beam.beam_decode_steps
    got = fn(params["decoder_char"], cfg.decoders["char"], BeamConfig(**bc),
             states[2][:rows], enc_lens[2][:rows])
    _assert_same(got, [np.asarray(x)[:rows] for x in want])


def test_ctc_loss_on_a_transformer_matches_jax(decode_jax):
    _, _, ccfg, cnamed, batch, labels, label_lens, _, (*_, want) = decode_jax
    params = checkpoint.params_from_named(cnamed, ccfg, "cpu")
    got = ctc.loss(params, ccfg, {
        "logmel": t(batch["logmel"]), "logmel_len": t(batch["logmel_len"]),
        "labels": t(labels), "label_lens": t(label_lens)})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_serving_batches_equal_one_request_at_a_time(decode_jax,
                                                      monkeypatch):
    """BatchingTranscriber over the transformer model (gate on): a burst
    batched 3 at a time gives what one request at a time gives."""
    cfg, named, *_, batch, _, _, _, _ = decode_jax
    monkeypatch.setenv("E2E_ASR_MHSA_KERNEL", "1")
    params = checkpoint.params_from_named(named, cfg, "cpu")
    rev_vocab = [f"t{i}" for i in range(V)]
    feats = [batch["logmel"][i, :n] for i, n in enumerate(LENS)]
    kw = dict(device="cpu", bucket_frames=(64,),
              beam_cfg=BeamConfig(beam_size=2, max_steps=8))
    with serving.BatchingTranscriber(params, cfg, rev_vocab, max_batch=3,
                                     **kw) as eng:
        got = [f.result(timeout=60) for f in [eng.submit(x) for x in feats]]
    with serving.BatchingTranscriber(params, cfg, rev_vocab, max_batch=1,
                                     **kw) as eng:
        single = [eng.transcribe(x) for x in feats]
    assert got == single and len(got) == 3


def test_cli_transformer_trains_and_evaluates(workspace, capsys,  # noqa
                                             monkeypatch):
    """cli.main -encoder_type transformer on the CPU: the run directory
    takes the JAX command's xfmr_4h_ name and parameters.txt its bytes;
    it trains two steps, then decodes the dev set greedily and by beam
    with the #18 gate on."""
    argv = _args(workspace, "-encoder_type", "transformer", "-num_heads",
                 "4", "-enc_subsample", "4")
    i = argv.index("-run_id")
    argv[i + 1] = "11"
    want = jmain.parse_options(argv)
    train_dir = want.train.train_dir
    assert os.path.basename(train_dir).startswith("xfmr_4h_")
    with open(os.path.join(train_dir, "parameters.txt"), "rb") as f:
        jax_text = f.read()
    main.main(argv)
    with open(os.path.join(train_dir, "parameters.txt"), "rb") as f:
        assert f.read() == jax_text
    named = checkpoint.load_named(os.path.join(train_dir, "asr.ckpt-2.npz"))
    assert "params/encoder/block_2/qkv/kernel" in named
    capsys.readouterr()
    monkeypatch.setenv("E2E_ASR_MHSA_KERNEL", "1")
    main.main(argv + ["-dev", "-beam_size", "2"])
    out = capsys.readouterr().out
    assert f"Using the model from: {train_dir}/asr.ckpt-2.npz" in out
    assert "Score:" in out


# ----------------------------------------------------------------- raises

@pytest.mark.parametrize("extra,item", [
    (dict(moe_experts=2), "Transformer family"),
    (dict(attn_chunk=4), "Transformer family"),
    (dict(remat=True), "Training extensions")])
def test_unported_options_raise(extra, item):
    cfg = xfmr_cfg(tasks=("char",), **extra)
    batch = make_batch(1)
    with pytest.raises(NotImplementedError, match=item):
        params = seq2seq.init(torch.Generator(), cfg, device="cpu")
        encoder.apply(params["encoder"], cfg.encoder, t(batch["logmel"]),
                      t(batch["logmel_len"]), {"char": 2}, train=True,
                      gen=torch.Generator())


@pytest.mark.parametrize("module", [lstm_bidir, gru_seq])
def test_wide_layers_raise_before_the_launch(module):
    """Kernels A (#1/#2) and #6/#7 keep a layer's units in one block: above
    1024 their wrappers raise ValueError naming 'Wide layers' before any
    launch (the check every CUDA path of the wrapper runs first)."""
    module.check_width(module.MAX_H)
    with pytest.raises(ValueError, match="Wide layers") as err:
        module.check_width(module.MAX_H + 32)
    assert "1024" in str(err.value)
