"""Kernel #13 (`attn_output_fused`: the additive attention folded into
kernel C) against its plain PyTorch version on the card (marker `cuda`;
skips without a GPU). Imports no JAX:
    pytest --noconftest -m cuda tests/test_torch_cuda_attn_output.py

Tolerance: 1e-4 absolute on log-probs, context and alpha (float32 sums in
another order); alpha exactly 0 on padded frames. With E2E_ASR_FUSED_ATTN
set, the greedy decode and the per-step beam search take #13 in place of
the attention and kernel C and decode the same ids as without it.
"""
import numpy as np
import pytest
import torch

from e2e_asr_tpu_torch.config import BeamConfig
from e2e_asr_tpu_torch.eval import beam
from e2e_asr_tpu_torch.kernels import attn_output, dec_step
from e2e_asr_tpu_torch.models import attn_decoder
from test_torch_cuda_beam_mega import _setup

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,k,T,H_enc,use_lstm", [
    (8, 4, 64, 512, True), (8, 4, 64, 512, False), (64, 1, 40, 512, True),
    (3, 5, 9, 16, False)])
def test_kernel_matches_plain(cuda, B, k, T, H_enc, use_lstm):
    lens = [T] + [max(1, T - 7 * i) for i in range(1, B)]
    wide = H_enc == 512
    cfg, params, (enc, hf, mask) = _setup(
        cuda, B=B, T=T, H_enc=H_enc, lens=lens, use_lstm=use_lstm,
        **(dict(hidden_size_dec=256, emb_size=256, attention_vec_size=128,
                lm_hidden_size=256) if wide else {}))
    rng = np.random.default_rng(B * k)
    N, H = B * k, cfg.hidden_size_dec
    y = torch.tensor(rng.normal(size=(N, cfg.attention_vec_size)).astype(
        np.float32), device=cuda)
    query = torch.tensor(rng.normal(size=(N, H)).astype(np.float32) * 0.5,
                         device=cuda)
    counts = attn_output.LAUNCHES, dec_step.OUTPUT_LAUNCHES
    got = attn_output.attn_output_fused(params, cfg, y, query, hf, enc, mask,
                                        k=k)
    torch.cuda.synchronize()
    assert (attn_output.LAUNCHES, dec_step.OUTPUT_LAUNCHES) == (
        counts[0] + 1, counts[1])
    want = attn_output.attn_output_fused_reference(params, cfg, y, query, hf,
                                                   enc, mask, k=k)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0)
    alpha = got[2].view(B, k, T)
    padded = mask[:, None].expand_as(alpha) == 0
    assert bool((alpha[padded] == 0).all())


@pytest.mark.cuda
def test_limits(cuda):
    cfg, params, (enc, hf, mask) = _setup(cuda, B=2, T=9, H_enc=16,
                                          lens=[9, 4])
    y = torch.zeros(6, cfg.attention_vec_size, device=cuda)
    query = torch.zeros(6, cfg.hidden_size_dec, device=cuda)
    with pytest.raises(ValueError, match="utterances"):
        attn_output.attn_output_fused(params, cfg, y, query, hf, enc, mask,
                                      k=2)
    long_hf = torch.zeros(2, 8200, cfg.attention_vec_size, device=cuda)
    with pytest.raises(ValueError, match="exceeds"):
        attn_output.attn_output_fused(
            params, cfg, y[:2], query[:2], long_hf,
            torch.zeros(2, 8200, 16, device=cuda),
            torch.ones(2, 8200, device=cuda), k=1)


@pytest.mark.cuda
@pytest.mark.parametrize("use_lstm", [True, False])
def test_route_opt_in(cuda, use_lstm, monkeypatch):
    cfg, params, (enc, _, _) = _setup(cuda, B=3, T=9, H_enc=16,
                                      lens=[9, 6, 3], use_lstm=use_lstm)
    lens = torch.tensor([9, 6, 3], device=cuda)
    go = torch.ones(3, dtype=torch.long, device=cuda)
    bc = BeamConfig(beam_size=3, max_steps=12)
    monkeypatch.delenv("E2E_ASR_FUSED_ATTN", raising=False)
    runs = []
    for opt_in in (False, True):
        if opt_in:
            monkeypatch.setenv("E2E_ASR_FUSED_ATTN", "1")
        counts = attn_output.LAUNCHES, dec_step.OUTPUT_LAUNCHES
        runs.append((attn_decoder.apply_infer_early(
            params, cfg, go, enc, lens, max_output=12),
            beam.beam_decode_steps(params, cfg, bc, enc, lens)))
        torch.cuda.synchronize()
        fused = attn_output.LAUNCHES - counts[0]
        unfused = dec_step.OUTPUT_LAUNCHES - counts[1]
        assert (fused > 0, unfused > 0) == (opt_in, not opt_in)
    (g0, b0), (g1, b1) = runs
    torch.testing.assert_close(g1, g0)
    torch.testing.assert_close(b1[:2], b0[:2])
    torch.testing.assert_close(b1[2], b0[2], atol=1e-4, rtol=0)
