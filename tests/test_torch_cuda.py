"""The CUDA kernels of e2e_asr_tpu_torch against their plain PyTorch
versions on the card (marker `cuda`; they skip without a GPU): A, B and C
and the whole decoder here, D in tests/test_torch_cuda_select.py.

These files import no JAX, so they also run where JAX is not installed:
    pytest --noconftest -m cuda tests/test_torch_cuda*.py
(--noconftest: tests/conftest.py sets up the JAX CPU mesh).

Tolerances: float32 sums in another order than cuBLAS's: 1e-5 absolute for
one step, 1e-4 over a 64-step recurrence; the selection is exact.
"""
import numpy as np
import pytest
import torch

from e2e_asr_tpu_torch.core.cells import LSTMState
from e2e_asr_tpu_torch.core.checkpoint import to_device
from e2e_asr_tpu_torch.eval import beam_eval
from e2e_asr_tpu_torch.kernels import dec_step, lstm_bidir
from e2e_asr_tpu_torch.models import attn_decoder, seq2seq
from e2e_asr_tpu_torch.config import (BeamConfig, DecoderConfig,
                                      EncoderConfig, Seq2SeqConfig)

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, *shape, scale=1.0, device="cpu"):
    return torch.tensor(rng.normal(size=shape).astype(np.float32) * scale,
                        device=device)


def fwd_route(H: int) -> str:
    """The forward walk's route by width (csrc/lstm_bidir.cu): a block's
    gate columns of W_h stay in shared memory up to H = 320."""
    return "resident" if H <= 320 else "streamed"


# (T, B, H): both routes of the forward walk (H = 40, 256 | 400, 1024; 400
# and 40 leave the last blocks' units part padding).
@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(64, 5, 40), (16, 8, 256), (16, 8, 400),
                                   (12, 3, 1024)])
def test_lstm_bidir_kernel(cuda, T, B, H):
    rng = np.random.default_rng(0)
    lens = rng.integers(1, T + 1, size=B)
    lens[0] = T
    mask = (np.arange(T)[:, None] >= T - lens[None, :]).astype(np.float32)
    args = [_rand(rng, T, B, 4 * H, device=cuda),
            _rand(rng, T, B, 4 * H, device=cuda),
            _rand(rng, H, 4 * H, scale=0.1, device=cuda),
            _rand(rng, H, 4 * H, scale=0.1, device=cuda),
            torch.tensor(mask[:, :, None], device=cuda)]
    before = lstm_bidir.LAUNCHES
    routes = dict(lstm_bidir.FWD_ROUTES)
    got = lstm_bidir.lstm_seq_bidir(*args)
    torch.cuda.synchronize()
    assert lstm_bidir.LAUNCHES == before + 1
    route = fwd_route(H)
    assert lstm_bidir.FWD_LAST_PLAN["route"] == route
    assert {k: lstm_bidir.FWD_ROUTES[k] - routes[k] for k in routes} == {
        r: int(r == route) for r in routes}
    want = lstm_bidir.lstm_seq_bidir_reference(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("layers,lm_hidden", [(1, 16), (2, 16), (1, 24),
                                              (2, 24)])
def test_dec_step_kernels(cuda, layers, lm_hidden):
    """B and C at a row count that is not a multiple of the 8-row tile,
    with and without SimpleProjection (lm_hidden != hidden)."""
    cfg = DecoderConfig(hidden_size_dec=16, emb_size=12, vocab_size=37,
                        attention_vec_size=8, lm_hidden_size=lm_hidden,
                        num_layers_dec=layers)
    params = to_device(attn_decoder.init(torch.Generator().manual_seed(0),
                                          cfg, 20), cuda)
    rng = np.random.default_rng(1)
    N = 37
    r = lambda *s: _rand(rng, *s, device=cuda)  # noqa: E731
    args = (params, r(N, 12), r(N, 20), LSTMState(r(N, lm_hidden),
                                                  r(N, lm_hidden)),
            tuple(LSTMState(r(N, 16), r(N, 16)) for _ in range(layers)))
    before = (dec_step.CELLS_LAUNCHES, dec_step.OUTPUT_LAUNCHES)
    new_lm, new_dec, y = dec_step.cells_fused(*args)
    logp = dec_step.output_fused(params, cfg, new_dec[-1].c, args[2])
    torch.cuda.synchronize()
    assert (dec_step.CELLS_LAUNCHES, dec_step.OUTPUT_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    w_lm, w_dec, w_y = dec_step.cells_fused_reference(*args)
    got = [new_lm.c, new_lm.h, y] + [x for s in new_dec for x in s]
    want = [w_lm.c, w_lm.h, w_y] + [x for s in w_dec for x in s]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    torch.testing.assert_close(
        logp, dec_step.output_fused_reference(params, cfg, new_dec[-1].c,
                                              args[2]), atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_beam_decoder_cuda_matches_cpu(cuda):
    """The whole decoder on the card (all four kernels) gives the CPU plain
    path's hypotheses on a small model."""
    cfg = Seq2SeqConfig(
        tasks=["char"], num_layers={"char": 2}, max_output={"char": 12},
        encoder=EncoderConfig(hidden_size=16),
        decoders={"char": DecoderConfig(
            hidden_size_dec=16, emb_size=12, vocab_size=20,
            attention_vec_size=8, lm_hidden_size=16, max_output=12)},
        feat_length=8)
    params = seq2seq.init(torch.Generator().manual_seed(3), cfg,
                          device="cpu")
    rng = np.random.default_rng(3)
    batch = {"logmel": rng.normal(size=(4, 24, 8)).astype(np.float32),
             "logmel_len": np.array([24, 17, 9, 2])}
    decode = beam_eval.make_beam_decoder(cfg, BeamConfig(beam_size=3,
                                                         max_steps=12))
    want = decode(params, batch)
    got = decode(to_device(params, cuda), batch)
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].numpy())
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].numpy())
    np.testing.assert_allclose(got[2].cpu().numpy(), want[2].numpy(),
                               atol=1e-4, rtol=0)
