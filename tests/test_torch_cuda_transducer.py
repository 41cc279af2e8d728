"""Kernel #17 (`kernels/transducer.py`: the transducer lattice loss,
forward and backward) against its plain PyTorch versions on the card
(marker `cuda`; skips without a GPU). Imports no JAX:
    pytest --noconftest -m cuda tests/test_torch_cuda_transducer.py

Cases: more examples than the card's 132 SMs (two waves of blocks), a
label axis wider than one warp and one wider than a block (threads take
several cells of a diagonal), the bench's lattice, ragged lengths with
t_len = 1 and u_len = 0 among them. The kernels run as the training step
runs them (the backward on the forward kernel's alpha and loss), and so
does the float32 plain version; both are held to the plain version in
float64. Tolerances: the loss 1e-5 relative (float32 sums in another
order: the plain version scans each row, the kernel walks diagonals).
The gradients are occupancies exp(alpha + beta - logZ) times g, whose
float32 error is |g| times the rounding of the log-space sums alpha and
beta, which grow with the lattice (the losses reach about 230 at the
bench's lattice): each kernel gradient's error against float64 is held
to twice the float32 plain version's, or to 1e-6 (16 float32 ulps) of
the largest loss times max |g|, whichever is larger. Gradients are
exactly 0 outside each example's lattice.
"""
import numpy as np
import pytest
import torch

from e2e_asr_tpu_torch.config import (DecoderConfig, EncoderConfig,
                                      LMConfig, Seq2SeqConfig)
from e2e_asr_tpu_torch.core.checkpoint import named_from_params
from e2e_asr_tpu_torch.kernels import transducer as kernel
from e2e_asr_tpu_torch.models import transducer
from e2e_asr_tpu_torch.train import step

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def lattice(dev, B, T, U1, seed=0):
    """Random lattices with ragged lengths (t_len = 1 and u_len = 0 in the
    first rows, full lengths in the last)."""
    rng = np.random.default_rng(seed)
    blank = rng.normal(size=(B, T, U1)).astype(np.float32) - 1.0
    label = rng.normal(size=(B, T, U1 - 1)).astype(np.float32) - 1.0
    tl = rng.integers(1, T + 1, size=B)
    ul = rng.integers(0, U1, size=B)
    tl[0], ul[1], tl[-1], ul[-1] = 1, 0, T, U1 - 1
    return [torch.tensor(a, device=dev) for a in (blank, label, tl, ul)]


CASES = [(140, 20, 10), (6, 12, 70), (3, 5, 1030), (128, 48, 48)]


def plain_chain(args, g, dtype):
    """The plain versions' loss and gradients with the lattices in dtype."""
    a = [args[0].to(dtype), args[1].to(dtype), *args[2:]]
    loss, alpha = kernel.transducer_fwd_reference(*a)
    return (loss, *kernel.transducer_bwd_reference(*a, alpha, loss,
                                                   g.to(dtype)))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,U1", CASES)
def test_kernels_match_plain(cuda, B, T, U1):
    args = lattice(cuda, B, T, U1, seed=B + U1)
    g = torch.linspace(-1.0, 2.0, B, device=cuda)
    counts = kernel.FWD_LAUNCHES, kernel.BWD_LAUNCHES
    loss, alpha = kernel.transducer_fwd(*args)
    gb, gl = kernel.transducer_bwd(*args, alpha, loss, g)
    torch.cuda.synchronize()
    assert (kernel.FWD_LAUNCHES, kernel.BWD_LAUNCHES) == (
        counts[0] + 1, counts[1] + 1)
    plain = plain_chain(args, g, torch.float32)
    exact = plain_chain(args, g, torch.float64)
    torch.testing.assert_close(loss, plain[0], rtol=1e-5, atol=0)
    torch.testing.assert_close(loss.double(), exact[0], rtol=1e-5, atol=0)
    ulps = 1e-6 * float(exact[0].abs().max() * g.abs().max())
    for name, got, want, best in (("gblank", gb, plain[1], exact[1]),
                                  ("glabel", gl, plain[2], exact[2])):
        err = float((got.double() - best).abs().max())
        plain_err = float((want.double() - best).abs().max())
        assert err <= max(2 * plain_err, ulps), (name, err, plain_err, ulps)
    tl, ul = args[2][:, None, None], args[3][:, None, None]
    t = torch.arange(T, device=cuda)[None, :, None]
    u = torch.arange(U1, device=cuda)[None, None, :]
    assert (gb[(t >= tl) | (u > ul)] == 0).all()
    assert (gl[(t >= tl) | (u[..., :-1] >= ul)] == 0).all()


@pytest.mark.cuda
def test_autograd_entry_matches_the_cpu(cuda):
    """transducer_loss on CUDA tensors (both kernels through autograd)
    against the same call on the CPU (autograd of the plain forward)."""
    runs = []
    for dev in (torch.device("cpu"), cuda):
        blank, label, tl, ul = lattice(dev, 9, 15, 12, seed=3)
        blank.requires_grad_(True)
        label.requires_grad_(True)
        loss = kernel.transducer_loss(blank, label, tl, ul)
        grads = torch.autograd.grad(loss.mean(), [blank, label])
        runs.append([x.detach().cpu() for x in (loss, *grads)])
    (loss_c, gb_c, gl_c), (loss_g, gb_g, gl_g) = runs
    torch.testing.assert_close(loss_g, loss_c, rtol=1e-5, atol=0)
    torch.testing.assert_close(gb_g, gb_c, rtol=0, atol=1e-5)
    torch.testing.assert_close(gl_g, gl_c, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_transducer_step_on_the_card_matches_the_cpu(cuda):
    """A small transducer model's loss and gradients through asr_step's
    loss_and_grads on the card (kernels #1, #2, #3, #5 and #17) and on the
    CPU, with the same noise: loss 1e-5 relative, gradients 1e-4 of each
    leaf's largest value."""
    cfg = Seq2SeqConfig(tasks=["char"], num_layers={"char": 2},
                        max_output={"char": 10},
                        encoder=EncoderConfig(hidden_size=16, out_prob=0.8),
                        feat_length=8, model_family="transducer")
    cfg.decoders["char"] = DecoderConfig(
        hidden_size_dec=16, emb_size=8, vocab_size=12, joint_dim=16,
        out_prob_dec=0.8, max_output=10)
    gen = torch.Generator().manual_seed(0)
    params = transducer.init(gen, cfg, 12, device="cpu")
    rng = np.random.default_rng(1)
    B, T, L = 5, 24, 7
    char_len = np.array([6, 4, 1, 6, 3])
    ids = np.zeros((B, L), np.int64)
    ids[:, 0] = 1
    for i, n in enumerate(char_len):
        ids[i, 1:n] = rng.integers(3, 12, size=n - 1)
        ids[i, n] = 2
    batch = {"logmel": rng.normal(size=(B, T, 8)).astype(np.float32),
             "logmel_len": np.array([24, 20, 9, 17, 24]), "char": ids,
             "char_len": char_len}
    noise = {"encoder": {1: torch.rand(T, B, 32, generator=gen) < 0.8,
                         2: torch.rand(T // 2, B, 32, generator=gen) < 0.8},
             "pred": transducer.train_noise(gen, cfg, L, B, "cpu")}
    runs, counts = [], (kernel.FWD_LAUNCHES, kernel.BWD_LAUNCHES)
    for dev in ("cpu", cuda):
        asr_step, _ = step.make_train_step(cfg, LMConfig(), device=dev)
        state = step.create_state(params, cfg, LMConfig(), device=dev)
        loss, _, grads = asr_step.loss_and_grads(state.params, batch, None,
                                                 noise)
        runs.append((float(loss), named_from_params(grads)))
    assert (kernel.FWD_LAUNCHES, kernel.BWD_LAUNCHES) == (
        counts[0] + 1, counts[1] + 1)
    (loss_c, g_c), (loss_g, g_g) = runs
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    for name, want in g_c.items():
        scale = max(float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(g_g[name], want, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
