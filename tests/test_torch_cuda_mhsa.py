"""Kernel #18 (`kernels/mhsa.py`, `csrc/mhsa.cu`: the transformer encoder's
self-attention core) against its plain PyTorch version on the card (marker
`cuda`; skips without a GPU). Imports no JAX:
    pytest --noconftest -m cuda tests/test_torch_cuda_mhsa.py

Shapes: the serving burst's buckets (B=8, T' = 16, 32, 64, nh 4, hd 128)
and `-test` at a batch of 64 (T' = 47), with and without relmat, ragged
lengths and a zero-length row; also several query tiles and key chunks
(T=100), the two-group head width 256 and small odd ones. Tolerance 1e-5
absolute on out and probs (float32 sums in another order). Through the
encoder: with E2E_ASR_MHSA_KERNEL set, inference launches #18 once a block
and gives the states of the plain chain; training never launches it. Also
the raises before any launch: head widths, alignment, and 'Wide layers'
above H = 1024 for kernels A and #6.
"""
import numpy as np
import pytest
import torch

from e2e_asr_tpu_torch.config import EncoderConfig
from e2e_asr_tpu_torch.kernels import gru_seq, lstm_bidir, mhsa
from e2e_asr_tpu_torch.models import encoder

torch.set_num_threads(1)
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def case(dev, B, nh, T, hd, rel, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.tensor(rng.normal(size=(B, nh, T, hd)).astype(
        np.float32), device=dev) for _ in range(3))
    lens = rng.integers(1, T + 1, size=B)
    lens[0], lens[-1] = T, 0
    pad = torch.tensor(np.where(np.arange(T)[None, :] < lens[:, None], 0.0,
                                -1e30).astype(np.float32), device=dev)
    relmat = (torch.tensor((rng.normal(size=(nh, T, T)) * 0.3).astype(
        np.float32), device=dev) if rel
        else torch.zeros(nh, T, T, device=dev))
    return q, k, v, pad, relmat


@pytest.mark.cuda
@pytest.mark.parametrize("B,nh,T,hd", [
    (8, 4, 16, 128), (8, 4, 32, 128), (8, 4, 64, 128), (64, 4, 47, 128),
    (3, 2, 100, 64), (2, 2, 40, 256), (5, 3, 9, 8), (2, 1, 33, 4)])
@pytest.mark.parametrize("rel", [False, True])
def test_kernel_matches_plain(cuda, B, nh, T, hd, rel):
    args = case(cuda, B, nh, T, hd, rel, seed=B * T + hd)
    before = mhsa.LAUNCHES
    out, probs = mhsa.attend(*args, return_probs=True)
    torch.cuda.synchronize()
    assert mhsa.LAUNCHES == before + 1
    want_out, want_probs = mhsa.attend_reference(*args)
    torch.testing.assert_close(out, want_out, atol=TOL, rtol=0)
    torch.testing.assert_close(probs, want_probs, atol=TOL, rtol=0)
    torch.testing.assert_close(probs[-1], torch.full_like(probs[-1], 1 / T),
                               atol=1e-7, rtol=0)      # the zero-length row


@pytest.mark.cuda
def test_autograd_form_on_the_card(cuda):
    """The kernel's forward with the plain backward from its probs: the
    gradients of the plain chain's autograd."""
    args = case(cuda, 4, 4, 24, 32, True, seed=3)
    g = torch.randn(4, 4, 24, 32, device=cuda)
    leaves = [a.clone().requires_grad_(True) for a in args]
    ref = [a.clone().requires_grad_(True) for a in args]
    before = mhsa.LAUNCHES
    got = torch.autograd.grad(mhsa.attend(*leaves), leaves[:3] + [leaves[4]],
                              g)
    assert mhsa.LAUNCHES == before + 1
    want = torch.autograd.grad(mhsa.attend_reference(*ref)[0],
                               ref[:3] + [ref[4]], g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4 * float(b.abs().max()),
                                   rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("rel,conv", [(False, 0), (True, 15)])
def test_encoder_gate(cuda, monkeypatch, rel, conv):
    """The transformer encoder at the bench's width (4 blocks, d_model 512,
    4 heads): with the gate, inference launches #18 once a block and
    matches the plain chain; training does not launch it."""
    cfg = EncoderConfig(hidden_size=256, encoder_type="transformer",
                        num_heads=4, ffn_mult=4, subsample=8,
                        rel_pos_bias=rel, conv_kernel=conv)
    gen = torch.Generator().manual_seed(0)
    params = encoder.init(gen, cfg, 4, 80, device=cuda)
    if rel:
        for i in range(1, 5):
            params[f"block_{i}"]["rel_bias"].normal_(0, 0.5)
    x = torch.randn(8, 512, 80, device=cuda)
    lens = torch.tensor([512, 500, 420, 300, 257, 128, 64, 9])
    layers = {"char": 4, "phone": 3}
    with torch.no_grad():
        monkeypatch.delenv("E2E_ASR_MHSA_KERNEL", raising=False)
        plain, _, _ = encoder.apply(params, cfg, x, lens, layers)
        monkeypatch.setenv("E2E_ASR_MHSA_KERNEL", "1")
        before = mhsa.LAUNCHES
        fused, _, _ = encoder.apply(params, cfg, x, lens, layers)
        assert mhsa.LAUNCHES == before + 4
    for d in (3, 4):
        torch.testing.assert_close(fused[d], plain[d], atol=1e-4, rtol=0)
    before = mhsa.LAUNCHES
    encoder.apply(params, cfg, x, lens, layers, train=True,
                  gen=torch.Generator(device=cuda).manual_seed(1))
    assert mhsa.LAUNCHES == before


@pytest.mark.cuda
def test_limits_raise_before_any_launch(cuda):
    before = mhsa.LAUNCHES
    for hd in (6, 260):
        with pytest.raises(ValueError, match="head width"):
            mhsa.attend(*case(cuda, 2, 2, 8, hd, False))
    q, k, v, pad, relmat = case(cuda, 2, 2, 8, 8, False)
    flat = torch.zeros(q.numel() + 1, device=cuda)
    odd = flat[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        mhsa.attend(odd, k, v, pad, relmat)
    with pytest.raises(ValueError, match="contiguous"):
        mhsa.attend(q.transpose(2, 3).contiguous().transpose(2, 3), k, v,
                    pad, relmat)
    assert mhsa.LAUNCHES == before


@pytest.mark.cuda
def test_wide_layers_raise_before_the_launch(cuda):
    """Kernel A and #6 above H = 1024 raise ValueError naming 'Wide layers'
    (the JAX package runs such layers on its XLA scan; the port has no
    wide form yet), not a bare CUDA error."""
    T, B, H = 3, 2, 1056
    xp = torch.zeros(T, B, 4 * H, device=cuda)
    w = torch.zeros(H, 4 * H, device=cuda)
    mask = torch.ones(T, B, 1, device=cuda)
    counts = lstm_bidir.LAUNCHES, gru_seq.LAUNCHES
    with pytest.raises(ValueError, match="Wide layers"):
        lstm_bidir.lstm_seq_bidir(xp, xp, w, w, mask)
    gx = torch.zeros(T, B, 2 * H, device=cuda)
    cx = torch.zeros(T, B, H, device=cuda)
    wg = torch.zeros(H, 2 * H, device=cuda)
    wc = torch.zeros(H, H, device=cuda)
    with pytest.raises(ValueError, match="Wide layers"):
        gru_seq.gru_seq_bidir(gx, cx, gx, cx, wg, wc, wg, wc, mask)
    assert (lstm_bidir.LAUNCHES, gru_seq.LAUNCHES) == counts
