"""Port parity for kernel #17, the transducer lattice loss, on the CPU:
the plain forward (`kernels/transducer.transducer_fwd_reference`, which
`core/transducer_loss.transducer_loss` runs on CPU tensors) and the plain
backward (`transducer_bwd_reference`), against the numpy oracle, torch
autograd, the JAX package's XLA path and its Pallas kernel in interpret
mode (`ops/transducer_pallas.transducer_loss_pallas`, forward and VJP).

The many ragged cases run against the numpy oracle, which compiles
nothing; each JAX function compiles once, at the one shape (4, 7, 6).
Tolerances (float32 against float64 or float32 in other orders): the
plain loss within 1e-4 absolute of the oracle; loss and gradients within
1e-5 of JAX's XLA path and of the Pallas kernel; the plain backward within
1e-5 of autograd through the plain forward.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_tpu.core import transducer_loss as jloss
from e2e_asr_tpu.ops import transducer_pallas as jpallas
from e2e_asr_tpu_torch.core import transducer_loss as tloss
from e2e_asr_tpu_torch.kernels import transducer as kernel

torch.set_num_threads(1)
NEG = kernel.NEG


def lattice(B, T, U1, t_lens, u_lens, seed=0):
    """Random lattices of [B, T, U1] nodes (label [B, T, U1-1]) and the
    given lengths, as numpy arrays."""
    rng = np.random.default_rng(seed)
    blank = rng.normal(size=(B, T, U1)).astype(np.float32) - 1.0
    label = rng.normal(size=(B, T, U1 - 1)).astype(np.float32) - 1.0
    return (blank, label, np.asarray(t_lens, np.int32),
            np.asarray(u_lens, np.int32))


def masked(label, u_lens):
    """The labels past each u_len at log 0, as both packages mask them."""
    u = np.arange(label.shape[-1])[None, None, :]
    return np.where(u < u_lens[:, None, None], label, NEG)


def port_loss_and_grads(blank, label, tl, ul, w):
    """The port's per-example loss and the gradients of sum(loss * w)."""
    b = torch.tensor(blank, requires_grad=True)
    lab = torch.tensor(label, requires_grad=True)
    loss = tloss.transducer_loss(b, lab, torch.tensor(tl), torch.tensor(ul))
    gb, gl = torch.autograd.grad((loss * torch.tensor(w)).sum(), [b, lab])
    return loss.detach().numpy(), gb.numpy(), gl.numpy()


# Ragged cases, (B, T, U+1, t_lens, u_lens): one frame; no labels;
# t_len < T beside full rows; u_len < U beside u_len = U; a mixed batch.
CASES = [(3, 1, 5, [1, 1, 1], [4, 0, 2]),
         (3, 5, 1, [5, 2, 1], [0, 0, 0]),
         (4, 7, 6, [7, 3, 1, 5], [5, 5, 5, 5]),
         (4, 6, 8, [6, 6, 6, 6], [7, 3, 0, 6]),
         (5, 9, 9, [9, 4, 1, 7, 2], [8, 0, 5, 2, 8])]


@pytest.mark.parametrize("B,T,U1,t_lens,u_lens", CASES)
def test_plain_loss_matches_the_oracle(B, T, U1, t_lens, u_lens):
    blank, label, tl, ul = lattice(B, T, U1, t_lens, u_lens, seed=B * T)
    got = tloss.transducer_loss(torch.tensor(blank), torch.tensor(label),
                                torch.tensor(tl), torch.tensor(ul))
    want = tloss.transducer_loss_reference(blank, masked(label, ul), tl, ul)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # The torch copy of the oracle is the JAX package's.
    np.testing.assert_array_equal(want, jloss.transducer_loss_reference(
        blank, masked(label, ul), tl, ul))


def test_plain_backward_matches_autograd():
    """transducer_bwd_reference against autograd through the plain
    forward, on every ragged case at once; gradients outside each
    example's lattice are exactly zero."""
    for B, T, U1, t_lens, u_lens in CASES:
        blank, label, tl, ul = lattice(B, T, U1, t_lens, u_lens, seed=7)
        w = np.random.default_rng(1).normal(size=B).astype(np.float32)
        loss, gb, gl = port_loss_and_grads(blank, label, tl, ul, w)
        _, alpha = kernel.transducer_fwd_reference(
            *(torch.tensor(a) for a in (blank, label, tl, ul)))
        pb, pl = kernel.transducer_bwd_reference(
            *(torch.tensor(a) for a in (blank, label, tl, ul)), alpha,
            torch.tensor(loss), torch.tensor(w))
        np.testing.assert_allclose(pb.numpy(), gb, rtol=0, atol=1e-5)
        np.testing.assert_allclose(pl.numpy(), gl, rtol=0, atol=1e-5)
        t = np.arange(T)[None, :, None]
        u = np.arange(U1)[None, None, :]
        out_b = (t >= tl[:, None, None]) | (u > ul[:, None, None])
        out_l = (t >= tl[:, None, None]) | (u[..., :-1] >= ul[:, None, None])
        assert np.all(pb.numpy()[out_b] == 0.0)
        assert np.all(pl.numpy()[out_l] == 0.0)


SHAPE = (4, 7, 6, [7, 3, 1, 5], [5, 2, 0, 4])


def test_loss_and_gradients_match_the_xla_path():
    blank, label, tl, ul = lattice(*SHAPE, seed=3)
    w = np.random.default_rng(2).normal(size=4).astype(np.float32)

    @jax.jit
    def run(b, lab):
        def f(b, lab):
            loss = jloss.transducer_loss(b, lab, jnp.asarray(tl),
                                         jnp.asarray(ul), impl="xla")
            return jnp.sum(loss * w), loss
        return jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(b, lab)

    (_, want), (want_gb, want_gl) = run(blank, label)
    loss, gb, gl = port_loss_and_grads(blank, label, tl, ul, w)
    np.testing.assert_allclose(loss, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gb, np.asarray(want_gb), rtol=0, atol=1e-5)
    np.testing.assert_allclose(gl, np.asarray(want_gl), rtol=0, atol=1e-5)


def test_plain_versions_match_the_pallas_kernel():
    """The plain forward and backward against the TPU kernel in interpret
    mode (the backward through its custom VJP)."""
    blank, label, tl, ul = lattice(*SHAPE, seed=4)
    w = np.random.default_rng(3).normal(size=4).astype(np.float32)
    loss, vjp = jax.vjp(
        lambda b, lab: jpallas.transducer_loss_pallas(
            b, lab, jnp.asarray(tl), jnp.asarray(ul)),
        jnp.asarray(blank), jnp.asarray(label))
    want_gb, want_gl = vjp(jnp.asarray(w))
    args = [torch.tensor(a) for a in (blank, label, tl, ul)]
    got, alpha = kernel.transducer_fwd_reference(*args)
    gb, gl = kernel.transducer_bwd_reference(*args, alpha, got,
                                             torch.tensor(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(loss), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gb.numpy(), np.asarray(want_gb), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(gl.numpy(), np.asarray(want_gl), rtol=0,
                               atol=1e-5)


def random_batch(seed):
    """A random ragged batch (1-5 rows, 1-9 frames, 0-7 labels) with its
    own lengths, from the seed."""
    rng = np.random.default_rng(100 + seed)
    B, T, U1 = (int(rng.integers(1, 6)), int(rng.integers(1, 10)),
                int(rng.integers(1, 9)))
    return lattice(B, T, U1, rng.integers(1, T + 1, size=B),
                   rng.integers(0, U1, size=B), seed=seed)


def brute_force_nll(blank, label, t_len, u_len):
    """-log of the sum over every alignment of one example, enumerated: the
    t_len - 1 frame steps and u_len labels in any order, then the final
    blank at (t_len - 1, u_len). No recurrence."""
    blank = np.asarray(blank, np.float64)
    label = np.asarray(label, np.float64)
    n, scores = t_len - 1 + u_len, []
    for emits in itertools.combinations(range(n), u_len):
        t = u = 0
        s = 0.0
        for i in range(n):
            if i in emits:
                s, u = s + label[t, u], u + 1
            else:
                s, t = s + blank[t, u], t + 1
        scores.append(s + blank[t, u])
    return -np.logaddexp.reduce(scores)


# (T, U+1, t_len, u_len) of row 0; row 1 fills its lattice.
BRUTE = [(1, 1, 1, 0), (1, 4, 1, 3), (4, 1, 4, 0), (3, 3, 3, 2),
         (4, 4, 2, 3), (5, 4, 5, 3), (4, 5, 3, 4), (6, 3, 4, 1)]


@pytest.mark.parametrize("T,U1,t_len,u_len", BRUTE)
def test_loss_is_minus_log_the_sum_over_alignments(T, U1, t_len, u_len):
    """The plain forward (float64 and float32) against every alignment
    enumerated: within 1e-9 in float64, 1e-4 in float32."""
    blank, label, tl, ul = lattice(2, T, U1, [t_len, T], [u_len, U1 - 1],
                                   seed=T * U1 + t_len)
    want = [brute_force_nll(blank[b], label[b], int(tl[b]), int(ul[b]))
            for b in range(2)]
    for dtype, atol in ((torch.float64, 1e-9), (torch.float32, 1e-4)):
        got = tloss.transducer_loss(torch.tensor(blank, dtype=dtype),
                                    torch.tensor(label, dtype=dtype),
                                    torch.tensor(tl), torch.tensor(ul))
        assert got.dtype == dtype
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def occupancies(blank, label, tl, ul):
    """Minus the plain backward's gradients at g = 1: the posterior
    occupancy of each blank and label transition, in float64."""
    args = [torch.tensor(a) for a in (blank.astype(np.float64),
                                      label.astype(np.float64), tl, ul)]
    loss, alpha = kernel.transducer_fwd_reference(*args)
    gb, gl = kernel.transducer_bwd_reference(
        *args, alpha, loss, torch.ones(len(tl), dtype=torch.float64))
    return -gb.numpy(), -gl.numpy()


@pytest.mark.parametrize("seed", range(6))
def test_occupancies_count_frames_and_labels(seed):
    """Every alignment takes exactly one blank in each of its frames and
    emits each of its labels once, so the occupancies from the plain
    backward sum to 1 over the nodes of every frame t < t_len (blank) and
    of every label u < u_len (label), and to 0 elsewhere (1e-9)."""
    blank, label, tl, ul = random_batch(seed)
    ob, ol = occupancies(blank, label, tl, ul)
    assert np.all(ob >= -1e-12) and np.all(ol >= -1e-12)
    for b in range(len(tl)):
        per_frame = ob[b].sum(axis=1)
        np.testing.assert_allclose(
            per_frame, (np.arange(len(per_frame)) < tl[b]).astype(float),
            rtol=0, atol=1e-9)
        per_label = ol[b].sum(axis=0)
        np.testing.assert_allclose(
            per_label, (np.arange(len(per_label)) < ul[b]).astype(float),
            rtol=0, atol=1e-9)


@pytest.mark.parametrize("seed", range(6))
def test_plain_backward_matches_autograd_on_random_batches(seed):
    """transducer_bwd_reference against autograd through the plain forward
    for a random output gradient (1e-5)."""
    blank, label, tl, ul = random_batch(seed)
    w = np.random.default_rng(seed).normal(size=len(tl)).astype(np.float32)
    loss, gb, gl = port_loss_and_grads(blank, label, tl, ul, w)
    args = [torch.tensor(a) for a in (blank, label, tl, ul)]
    _, alpha = kernel.transducer_fwd_reference(*args)
    pb, pl = kernel.transducer_bwd_reference(*args, alpha, torch.tensor(loss),
                                             torch.tensor(w))
    np.testing.assert_allclose(pb.numpy(), gb, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pl.numpy(), gl, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", range(6))
def test_values_outside_each_lattice_change_nothing(seed):
    """Junk written where t >= t_len, u > u_len (blank) or u >= u_len
    (label) leaves the loss and both gradients of the plain versions as
    they were (1e-6), and the gradients there exactly 0."""
    blank, label, tl, ul = random_batch(seed)
    B, T, U1 = blank.shape
    t = np.arange(T)[None, :, None]
    u = np.arange(U1)[None, None, :]
    out_b = (t >= tl[:, None, None]) | (u > ul[:, None, None])
    out_l = (t >= tl[:, None, None]) | (u[..., :-1] >= ul[:, None, None])
    junk = np.random.default_rng(seed).normal(size=blank.shape) * 5.0
    blank2 = np.where(out_b, junk, blank).astype(np.float32)
    label2 = np.where(out_l, junk[..., :-1], label).astype(np.float32)
    w = np.ones(B, np.float32)
    runs = []
    for b_, l_ in ((blank, label), (blank2, label2)):
        args = [torch.tensor(a) for a in (b_, l_, tl, ul)]
        loss, alpha = kernel.transducer_fwd_reference(*args)
        runs.append((loss.numpy(), *(g.numpy() for g in
                     kernel.transducer_bwd_reference(
                         *args, alpha, loss, torch.tensor(w)))))
    for a, b in zip(*runs):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    assert np.all(runs[1][1][out_b] == 0.0)
    assert np.all(runs[1][2][out_l] == 0.0)


@pytest.mark.parametrize("seed", range(3))
def test_each_row_is_its_own_lattice(seed):
    """A batch's losses and gradients equal those of each row alone
    (1e-6)."""
    blank, label, tl, ul = random_batch(seed + 10)
    w = np.ones(len(tl), np.float32)
    loss, gb, gl = port_loss_and_grads(blank, label, tl, ul, w)
    for b in range(len(tl)):
        one = port_loss_and_grads(blank[b:b + 1], label[b:b + 1],
                                  tl[b:b + 1], ul[b:b + 1], w[b:b + 1])
        for got, want in zip(one, (loss, gb, gl)):
            np.testing.assert_allclose(got[0], want[b], rtol=0, atol=1e-6)


@pytest.mark.parametrize("B,T,U1,t_lens,u_lens",
                         [CASES[0], CASES[3], (2, 3, 3, [3, 2], [2, 1])])
def test_gradients_match_finite_differences(B, T, U1, t_lens, u_lens):
    """torch.autograd.gradcheck of the plain forward in float64 (central
    differences, eps 1e-6, atol 1e-5)."""
    blank, label, tl, ul = lattice(B, T, U1, t_lens, u_lens, seed=U1)
    b = torch.tensor(blank, dtype=torch.float64, requires_grad=True)
    lab = torch.tensor(label, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x, y: tloss.transducer_loss(x, y, torch.tensor(tl),
                                           torch.tensor(ul)),
        (b, lab), eps=1e-6, atol=1e-5)


def test_lengths_beyond_the_lattice_are_clamped():
    """t_len 0 reads as 1 and t_len > T as T; u_len > U reads as U: the
    oracle at the clamped lengths (1e-4)."""
    blank, label, _, _ = lattice(4, 5, 4, [5] * 4, [3] * 4, seed=9)
    tl = np.array([0, 9, 2, 5], np.int32)
    ul = np.array([1, 7, 5, 0], np.int32)
    got = tloss.transducer_loss(torch.tensor(blank), torch.tensor(label),
                                torch.tensor(tl), torch.tensor(ul))
    tl_c, ul_c = np.clip(tl, 1, 5), np.clip(ul, 0, 3)
    want = tloss.transducer_loss_reference(blank, masked(label, ul_c), tl_c,
                                           ul_c)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
