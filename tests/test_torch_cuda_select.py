"""Kernel D (beam selection) against its plain PyTorch version on the
card (marker `cuda`; skips without a GPU). Imports no JAX:
    pytest --noconftest -m cuda tests/test_torch_cuda_select.py

The selection is exact: integer outputs and vals are equal.
"""
import numpy as np
import pytest
import torch

from e2e_asr_tpu_torch.kernels import beam_select

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(rng, *shape, device):
    return torch.tensor(rng.normal(size=shape).astype(np.float32),
                        device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("B,k,V", [(8, 4, 40), (5, 3, 37), (2, 6, 100)])
def test_beam_select_kernel(cuda, B, k, V):
    rng = np.random.default_rng(2)
    scores = _rand(rng, B, k, device=cuda)
    logp = torch.log_softmax(_rand(rng, B, k, V, device=cuda), dim=-1)
    logp[0, :, 3] = logp[0, :, 5]                  # exact ties
    alive = torch.tensor(rng.random((B, k)) < 0.6, device=cuda)
    alive[:, 0] = True
    nf = torch.tensor(rng.integers(0, k, size=B), dtype=torch.int32,
                      device=cuda)
    before = beam_select.LAUNCHES
    got = beam_select.beam_select(scores, logp, alive, nf)
    torch.cuda.synchronize()
    assert beam_select.LAUNCHES == before + 1
    want = beam_select.beam_select_reference(scores, logp, alive, nf)
    for key in want:
        torch.testing.assert_close(got[key], want[key], atol=0, rtol=0)


@pytest.mark.cuda
def test_beam_select_kernel_non_finite_rows(cuda):
    """Rows with fewer than k candidates above -inf, and NaN scores (a
    diverged checkpoint): the kernel still picks k valid indices, in the
    plain version's order (NaN first, then by value, ties by index)."""
    B, k, V = 4, 4, 40
    rng = np.random.default_rng(4)
    scores = _rand(rng, B, k, device=cuda)
    logp = torch.log_softmax(_rand(rng, B, k, V, device=cuda), dim=-1)
    logp[0] = -torch.inf                           # every candidate -inf
    logp[1, :, 1:] = -torch.inf                    # k live, rest -inf
    logp[1, 2:, :] = -torch.inf                    # only 2 above -inf
    scores[2, 1] = torch.nan                       # a NaN parent
    logp[3, 0, 7] = torch.nan                      # one NaN candidate
    alive = torch.ones(B, k, dtype=torch.bool, device=cuda)
    alive[1, 3] = False
    nf = torch.tensor([0, 1, 2, 0], dtype=torch.int32, device=cuda)
    got = beam_select.beam_select(scores, logp, alive, nf)
    want = beam_select.beam_select_reference(scores, logp, alive, nf)
    for key in want:
        torch.testing.assert_close(got[key], want[key], atol=0, rtol=0,
                                   equal_nan=True)
