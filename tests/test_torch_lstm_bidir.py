"""Port parity: kernel A (bidirectional LSTM layer forward) and the encoder
layer around it, against the JAX package on the CPU.

Inputs come from a numpy seed and go through both frameworks. Tolerance:
1e-5 absolute, float32 sums taken in another order over a short recurrence.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_tpu.core import rnn as jrnn
from e2e_asr_tpu.ops import lstm_pallas
from e2e_asr_tpu_torch.core import rnn
from e2e_asr_tpu_torch.kernels import lstm_bidir

torch.set_num_threads(1)
ATOL = 1e-5


def _layer_inputs(seed, T=12, B=3, F=6, H=8):
    rng = np.random.default_rng(seed)
    params = {d: {"kernel": rng.uniform(-0.3, 0.3, (F + H, 4 * H)
                                        ).astype(np.float32),
                  "bias": rng.uniform(-0.1, 0.1, (4 * H,)).astype(np.float32)}
              for d in ("fw", "bw")}
    x = rng.normal(size=(T, B, F)).astype(np.float32)
    lens = rng.integers(1, T + 1, size=B).astype(np.int32)
    lens[0] = T
    return params, x, lens


def _kernel_inputs(seed, T=12, B=3, H=8):
    rng = np.random.default_rng(seed)
    xf = rng.normal(size=(T, B, 4 * H)).astype(np.float32)
    xb = rng.normal(size=(T, B, 4 * H)).astype(np.float32)
    wf = rng.uniform(-0.4, 0.4, (H, 4 * H)).astype(np.float32)
    wb = rng.uniform(-0.4, 0.4, (H, 4 * H)).astype(np.float32)
    lens = rng.integers(1, T + 1, size=B)
    lens[0] = T
    mask = (np.arange(T)[:, None] >= T - lens[None, :]).astype(np.float32)
    return xf, xb, wf, wb, mask[:, :, None]


def test_reference_matches_pallas_interpret():
    """The plain version equals the TPU kernel (interpret mode) on ragged
    lengths, including the backward direction's carry-through padding."""
    args = _kernel_inputs(0)
    want = lstm_pallas.lstm_seq_bidir(*map(jnp.asarray, args), None, False,
                                      1.0)
    got = lstm_bidir.lstm_seq_bidir_reference(*map(torch.tensor, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


def test_cpu_wrapper_uses_reference_and_counts_nothing():
    args = [torch.tensor(a) for a in _kernel_inputs(1)]
    before = lstm_bidir.LAUNCHES
    got = lstm_bidir.lstm_seq_bidir(*args)
    want = lstm_bidir.lstm_seq_bidir_reference(*args)
    assert lstm_bidir.LAUNCHES == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lstm_bidir.lstm_seq_bidir(*args, drop_keep=0.9)


def test_rnn_layer_matches_jax():
    params, x, lens = _layer_inputs(2)
    want = jrnn.rnn_layer(jax.tree_util.tree_map(jnp.asarray, params),
                          jnp.asarray(x), jnp.asarray(lens))
    got = rnn.rnn_layer(jax.tree_util.tree_map(torch.tensor, params),
                        torch.tensor(x), torch.tensor(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_rnn_layer_equals_reverse_within_length_scan():
    """Flip + carry-through (the kernel's formulation) equals running the
    plain scan on each example reversed within its own length."""
    params, x, lens = _layer_inputs(3)
    tp = jax.tree_util.tree_map(torch.tensor, params)
    x, lens = torch.tensor(x), torch.tensor(lens)
    got = rnn.rnn_layer(tp, x, lens)
    fw = rnn.lstm_scan_reference(tp["fw"], x, lens)
    bw = rnn.reverse_sequence(
        rnn.lstm_scan_reference(tp["bw"], rnn.reverse_sequence(x, lens),
                                lens), lens)
    torch.testing.assert_close(got, torch.cat([fw, bw], -1), atol=ATOL,
                               rtol=0)
    want_rev = jrnn.reverse_sequence(jnp.asarray(x.numpy()),
                                     jnp.asarray(lens.numpy()))
    np.testing.assert_array_equal(rnn.reverse_sequence(x, lens).numpy(),
                                  np.asarray(want_rev))

