"""Port parity for kernels #6 and #7 (the GRU layer's forward and backward)
and the GRU layers around them, against the JAX package on the CPU.

- `gru_seq_reference`, #6's plain version, against the Pallas kernel in
  interpret mode (`gru_seq` and `gru_seq_masked`, as
  tests/test_gru_pallas.py runs them) at T=6;
- `gru_bwd_reference`, #7's plain version, against jax.vjp of the masked
  Pallas entry (its custom VJP runs `_bwd_seq` in interpret mode);
- the CPU wrappers take the plain versions and count no launch;
- the bidirectional GRU `rnn_layer` (value and jax.vjp), the forward-only
  layer with output dropout, `gru_scan`, and the GRU encoder against the
  JAX package's XLA path on ragged lengths.

Tolerances: 1e-5 absolute on values of order 1 and 1e-4 relative to each
gradient's largest value (float32 sums in another order over short
recurrences).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from e2e_asr_tpu.config import EncoderConfig as JEncoderConfig
from e2e_asr_tpu.core import rnn as jrnn
from e2e_asr_tpu.models import encoder as jencoder
from e2e_asr_tpu.ops import gru_pallas
from e2e_asr_tpu_torch.config import EncoderConfig
from e2e_asr_tpu_torch.core import checkpoint, rnn
from e2e_asr_tpu_torch.kernels import gru_seq
from e2e_asr_tpu_torch.models import encoder
from tests.test_torch_train_step import quick_jit

torch.set_num_threads(1)
ATOL = 1e-5


def _inputs(seed, T=6, B=3, H=8):
    """gates_x, cand_x, w_gh, w_ch and the flipped sequence's mask."""
    rng = np.random.default_rng(seed)
    gx = rng.normal(size=(T, B, 2 * H)).astype(np.float32)
    cx = rng.normal(size=(T, B, H)).astype(np.float32)
    wg = rng.uniform(-0.4, 0.4, (H, 2 * H)).astype(np.float32)
    wc = rng.uniform(-0.4, 0.4, (H, H)).astype(np.float32)
    lens = rng.integers(1, T + 1, size=B)
    lens[0] = T
    mask = (np.arange(T)[:, None] >= T - lens[None, :]).astype(np.float32)
    return gx, cx, wg, wc, mask[:, :, None]


def _gru_params(rng, F, H, directions=("fw", "bw")):
    return {d: {"gates": {"kernel": rng.uniform(-0.3, 0.3, (F + H, 2 * H)
                                                ).astype(np.float32),
                          "bias": rng.uniform(0.8, 1.2, (2 * H,)
                                              ).astype(np.float32)},
                "candidate": {"kernel": rng.uniform(-0.3, 0.3, (F + H, H)
                                                    ).astype(np.float32),
                              "bias": rng.uniform(-0.1, 0.1, (H,)
                                                  ).astype(np.float32)}}
            for d in directions}


def _assert_rel(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


def test_plain_versions_match_pallas_and_its_vjp():
    """#6's plain version equals the Pallas kernel in interpret mode, both
    entries (gru_seq, gru_seq_masked), and #7's equals jax.vjp of the
    masked entry (the Pallas backward, interpret mode)."""
    gx, cx, wg, wc, mask = _inputs(0)
    g = np.random.default_rng(1).normal(size=cx.shape).astype(np.float32)
    args = [jnp.asarray(a) for a in (gx, cx, wg, wc)]
    want_plain = gru_pallas.gru_seq(*args)
    want, vjp = jax.vjp(lambda *a: gru_pallas.gru_seq_masked(
        *a, jnp.asarray(mask)), *args)
    want_grads = vjp(jnp.asarray(g))
    t = [torch.tensor(a) for a in (gx, cx, wg, wc)]
    np.testing.assert_allclose(gru_seq.gru_seq_reference(*t).numpy(),
                               np.asarray(want_plain), atol=ATOL, rtol=0)
    tm = torch.tensor(mask)
    h, ru, c = gru_seq.gru_seq_reference(*t, tm, save=True)
    np.testing.assert_allclose(h.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    torch.testing.assert_close(gru_seq.gru_seq_reference(*t, tm), h)
    got = gru_seq.gru_bwd_reference(t[2], t[3], h, ru, c, torch.tensor(g),
                                    tm)
    for a, b in zip(got, want_grads):
        _assert_rel(a.numpy(), b)


def test_cpu_wrappers_take_the_plain_versions():
    """On CPU tensors every entry runs the plain version and counts no
    launch; autograd through _GRUSeq and _GRUBidir (the plain backward)
    equals autograd through the plain forward."""
    gx, cx, wg, wc, mask = map(torch.tensor, _inputs(2, T=7))
    names = ("LAUNCHES", "SEQ_LAUNCHES", "MASKED_LAUNCHES", "TRAIN_LAUNCHES",
             "BWD_LAUNCHES", "BWD_SINGLE_LAUNCHES")
    before = [getattr(gru_seq, n) for n in names]
    leaves = [a.clone().requires_grad_(True) for a in (gx, cx, wg, wc)]
    w_bw = (wg * 0.5, wc.flip(0))
    h_fw, h_bw = gru_seq.gru_seq_bidir(*leaves[:2], gx.flip(0), cx.flip(0),
                                       *leaves[2:], *w_bw, mask)
    out = gru_seq.gru_seq(*leaves, mask)
    g = torch.randn(3, *out.shape, generator=torch.Generator().manual_seed(3))
    got = torch.autograd.grad((h_fw * g[0] + h_bw * g[1] + out * g[2]).sum(),
                              leaves)
    assert [getattr(gru_seq, n) for n in names] == before
    plain = [a.clone().requires_grad_(True) for a in (gx, cx, wg, wc)]
    want_out = (gru_seq.gru_seq_reference(*plain) * g[0]
                + gru_seq.gru_seq_reference(
                    gx.flip(0), cx.flip(0), *w_bw, mask) * g[1]
                + gru_seq.gru_seq_reference(*plain, mask) * g[2]).sum()
    want = torch.autograd.grad(want_out, plain)
    for a, b in zip(got, want):
        _assert_rel(a.numpy(), b.numpy())


def test_bidirectional_layer_matches_jax_and_its_vjp():
    """The bidirectional GRU rnn_layer (both directions in one #6 call,
    the backward one on the flipped input) equals JAX's reverse_sequence
    formulation on ragged lengths, value and gradients."""
    rng = np.random.default_rng(4)
    T, B, F, H = 9, 3, 5, 8
    params = _gru_params(rng, F, H)
    x = rng.normal(size=(T, B, F)).astype(np.float32)
    lens = np.array([T, 6, 2], np.int32)
    ct = rng.normal(size=(T, B, 2 * H)).astype(np.float32)

    def jax_vjp(p, xx, c):
        out, vjp = jax.vjp(lambda p, xx: jrnn.rnn_layer(
            p, xx, jnp.asarray(lens), cell="gru", impl="xla"), p, xx)
        return out, *vjp(c)

    out, jgp, jgx = jax.jit(jax_vjp)(params, x, ct)
    tp = jax.tree_util.tree_map(lambda a: torch.tensor(a, requires_grad=True),
                                params)
    tx = torch.tensor(x, requires_grad=True)
    got = rnn.rnn_layer(tp, tx, torch.tensor(lens), cell="gru")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=ATOL, rtol=0)
    got.backward(torch.tensor(ct))
    want = checkpoint.flatten_named(jgp)
    for name, leaf in checkpoint.flatten_named(tp).items():
        _assert_rel(leaf.grad.numpy(), want[name])
    _assert_rel(tx.grad.numpy(), jgx)


def test_scan_and_forward_only_layer_match_jax():
    rng = np.random.default_rng(5)
    T, B, F, H, keep = 8, 4, 5, 8, 0.7
    params = _gru_params(rng, F, H, ("fw",))
    x = rng.normal(size=(T, B, F)).astype(np.float32)
    lens = np.array([T, 5, 1, 3], np.int32)
    key = jax.random.PRNGKey(6)

    def jax_side(p, xs, ls):
        return (jrnn.gru_scan(p["fw"], xs, ls, impl="xla"),
                jrnn.rnn_layer(p, xs, ls, cell="gru", bidirectional=False,
                               impl="xla", out_dropout=(key, keep)),
                jax.random.bernoulli(key, keep, (T, B, H)))

    want_scan, want, mask = quick_jit(jax_side, params, x, lens)(params, x,
                                                                 lens)
    tp = jax.tree_util.tree_map(torch.tensor, params)
    tx, tl = torch.tensor(x), torch.tensor(lens)
    np.testing.assert_allclose(rnn.gru_scan(tp["fw"], tx, tl).numpy(),
                               np.asarray(want_scan), atol=ATOL, rtol=0)
    got = rnn.rnn_layer(tp, tx, tl, cell="gru", bidirectional=False,
                        out_dropout=(keep, torch.tensor(np.asarray(mask))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_gru_encoder_matches_jax():
    """The 3-layer pyramidal BiGRU encoder (skip 2) on ragged lengths: the
    port's init carried across by name, every requested depth's output."""
    cfg = EncoderConfig(hidden_size=8, use_lstm=False, skip_step=2,
                        max_scaling_down=4)
    jcfg = JEncoderConfig(**dataclasses.asdict(cfg))
    params = encoder.init(torch.Generator().manual_seed(7), cfg, 3, 6,
                          device="cpu")
    named = checkpoint.named_from_params(params)
    assert "layer_2/bw/candidate/kernel" in named
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, 13, 6)).astype(np.float32)
    lens = np.array([13, 9, 4], np.int32)
    layers = {"char": 3, "phone": 2}
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a.numpy()),
                                     params)
    want, _, want_lens = jax.jit(lambda p, xx: jencoder.apply(
        p, jcfg, xx, jnp.asarray(lens), layers))(jparams, x)
    with torch.no_grad():
        got, _, got_lens = encoder.apply(params, cfg, torch.tensor(x),
                                         torch.tensor(lens), layers)
    assert sorted(got) == sorted(want) == [2, 3]
    for depth in got:
        np.testing.assert_allclose(got[depth].numpy(),
                                   np.asarray(want[depth]), atol=ATOL,
                                   rtol=0)
        np.testing.assert_array_equal(got_lens[depth].numpy(),
                                      np.asarray(want_lens[depth]))
