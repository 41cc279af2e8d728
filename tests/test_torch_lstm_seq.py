"""Port parity for kernel #3 (the unidirectional LSTM forward) and the
layers around it, against the JAX package on the CPU.

- `lstm_seq_reference`, the kernel's plain version, against the Pallas
  kernel in interpret mode in all three forms (inference, masked, the
  training form that also saves c) at T=6;
- the CPU wrapper takes the plain version, counts no launch, and its
  autograd (kernel #5's plain version as the backward) matches jax.vjp of
  the JAX package's XLA scan;
- `core/rnn.lstm_scan` and the forward-only `rnn_layer` with output dropout
  (JAX's mask rebuilt from its key) against the JAX package;
- the cross entropy's row weights (the LM's padded tail batch).

Tolerances: 1e-5 absolute on values of order 1 and 1e-4 relative to each
gradient's largest value (float32 sums in another order over short
recurrences); 1e-6 relative on the loss.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_tpu.core import losses as jlosses
from e2e_asr_tpu.core import rnn as jrnn
from e2e_asr_tpu.ops import lstm_pallas
from e2e_asr_tpu_torch.core import losses, rnn
from e2e_asr_tpu_torch.kernels import lstm_bidir, lstm_seq

torch.set_num_threads(1)
ATOL = 1e-5


def _inputs(seed, T=6, B=3, H=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, B, 4 * H)).astype(np.float32)
    w = rng.uniform(-0.4, 0.4, (H, 4 * H)).astype(np.float32)
    lens = rng.integers(1, T + 1, size=B)
    lens[0] = T
    mask = (np.arange(T)[:, None] >= T - lens[None, :]).astype(np.float32)
    return x, w, mask[:, :, None]


@pytest.mark.parametrize("form", ["inference", "masked", "train"])
def test_reference_matches_pallas_interpret(form):
    x, w, mask = _inputs(0)
    jx, jw, jm = map(jnp.asarray, (x, w, mask))
    tx, tw, tm = map(torch.tensor, (x, w, mask))
    if form == "inference":
        want = [lstm_pallas.lstm_seq(jx, jw, None, False, 1.0)]
        got = [lstm_seq.lstm_seq_reference(tx, tw)]
    elif form == "masked":
        want = [lstm_pallas.lstm_seq_masked(jx, jw, jm, None, False, 1.0)]
        got = [lstm_seq.lstm_seq_reference(tx, tw, tm)]
    else:
        want = lstm_pallas._fwd_seq(jx, jw, save_c=True)
        got = lstm_seq.lstm_seq_reference(tx, tw, save_c=True)
    assert len(got) == len(want)
    for g, v in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(v), atol=ATOL,
                                   rtol=0)


def test_cpu_wrapper_and_backward_match_jax():
    """On CPU tensors the wrapper is the plain version and launches nothing;
    its backward (lstm_bwd's plain version) equals jax.vjp of the XLA
    scan."""
    x, w, mask = _inputs(1, T=9)
    counts = lambda: (lstm_seq.LAUNCHES, lstm_seq.MASKED_LAUNCHES,  # noqa
                      lstm_seq.TRAIN_LAUNCHES,
                      lstm_bidir.BWD_SINGLE_LAUNCHES)
    before = counts()
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    with torch.no_grad():
        torch.testing.assert_close(
            lstm_seq.lstm_seq(tx, tw, torch.tensor(mask)),
            lstm_seq.lstm_seq_reference(tx, tw, torch.tensor(mask)))
    h = lstm_seq.lstm_seq(tx, tw)
    g = np.random.default_rng(2).normal(size=h.shape).astype(np.float32)
    h.backward(torch.tensor(g))
    assert counts() == before

    def jfwd(xp, wh):        # an identity input kernel: x_proj = xp
        H4 = wh.shape[1]
        params = {"kernel": jnp.concatenate([jnp.eye(H4), wh]),
                  "bias": jnp.zeros(H4)}
        T, B = xp.shape[:2]
        return jrnn.lstm_scan(params, xp, jnp.full((B,), T), impl="xla")

    @jax.jit
    def jax_vjp(xp, wh, gh):
        out, vjp = jax.vjp(jfwd, xp, wh)
        return out, vjp(gh)

    want_h, want_grads = jax_vjp(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(g))
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(want_h),
                               atol=ATOL, rtol=0)
    for got, want in zip((tx.grad, tw.grad), want_grads):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def test_scan_and_forward_only_layer_match_jax():
    rng = np.random.default_rng(3)
    T, B, F, H, keep = 10, 4, 5, 8, 0.7
    params = {"fw": {"kernel": rng.uniform(-0.3, 0.3, (F + H, 4 * H)
                                           ).astype(np.float32),
                     "bias": rng.uniform(-0.1, 0.1, (4 * H,)
                                         ).astype(np.float32)}}
    x = rng.normal(size=(T, B, F)).astype(np.float32)
    lens = np.array([T, 7, 1, 4], np.int32)
    tp = jax.tree_util.tree_map(torch.tensor, params)
    tx, tl = torch.tensor(x), torch.tensor(lens)
    key = jax.random.PRNGKey(4)

    @jax.jit
    def jax_side(p, xs, ls):
        return (jrnn.lstm_scan(p["fw"], xs, ls, impl="xla"),
                jrnn.rnn_layer(p, xs, ls, bidirectional=False, impl="xla",
                               out_dropout=(key, keep)),
                jax.random.bernoulli(key, keep, (T, B, H)))

    want_scan, want, mask = jax_side(params, x, lens)
    np.testing.assert_allclose(rnn.lstm_scan(tp["fw"], tx, tl).numpy(),
                               np.asarray(want_scan), atol=ATOL, rtol=0)
    torch.testing.assert_close(rnn.lstm_scan(tp["fw"], tx, tl),
                               rnn.lstm_scan_reference(tp["fw"], tx, tl),
                               atol=ATOL, rtol=0)
    mask = torch.tensor(np.asarray(mask))
    got = rnn.rnn_layer(tp, tx, tl, bidirectional=False,
                        out_dropout=(keep, mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_cross_entropy_row_weights_match_jax():
    rng = np.random.default_rng(5)
    V = 7
    logits = rng.normal(size=(5, 4, V)).astype(np.float32)
    targets = rng.integers(0, V, size=(5, 4)).astype(np.int32)
    lens = np.array([5, 3, 1, 1], np.int32)
    for weights in (np.array([1, 1, 0, 0], np.float32),
                    np.zeros(4, np.float32)):
        want = jlosses.cross_entropy_loss(
            jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(lens),
            weights=jnp.asarray(weights))
        got = losses.cross_entropy_loss(
            torch.tensor(logits), torch.tensor(targets), torch.tensor(lens),
            weights=torch.tensor(weights))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
