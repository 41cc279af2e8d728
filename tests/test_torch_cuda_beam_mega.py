"""Kernel #15 (the whole beam search in one launch) against its plain
PyTorch version on the card (marker `cuda`; skips without a GPU). Imports
no JAX:
    pytest --noconftest -m cuda tests/test_torch_cuda_beam_mega.py

Each call is one launch. The two agree when their tokens and lengths are
equal and their scores within 1e-5 of |score| (at least 1e-4: sums of up
to 120 float32 log-probs), or when they part only at a near-tie: selection
values within 1e-3 up to the first selection that differs
(`beam_mega.parting`). Shapes past the kernel's limits raise, and
`beam_decode` then takes the per-step route.
"""
import dataclasses

import numpy as np
import pytest
import torch

from e2e_asr_tpu_torch.config import BeamConfig, DecoderConfig
from e2e_asr_tpu_torch.data.text import EOS_ID
from e2e_asr_tpu_torch.eval import beam
from e2e_asr_tpu_torch.kernels import beam_mega, dec_step
from e2e_asr_tpu_torch.models import attn_decoder

torch.set_num_threads(1)
NEAR_TIE = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _setup(cuda, *, B, T, H_enc, lens, eos_rig=False, **dec):
    cfg = DecoderConfig(**{**dict(hidden_size_dec=16, emb_size=12,
                                  vocab_size=40, attention_vec_size=8,
                                  lm_hidden_size=16), **dec})
    params = attn_decoder.init(torch.Generator().manual_seed(B + T), cfg,
                               H_enc, device=cuda)
    if eos_rig:     # every hypothesis emits <eos> at its first step
        out = params["output_proj"]
        out["kernel"].zero_()
        out["bias"][EOS_ID] = 50.0
    rng = np.random.default_rng(T)
    enc = torch.tensor(rng.normal(size=(B, T, H_enc)).astype(np.float32),
                       device=cuda)
    ctx = attn_decoder.make_attn_context(params, enc,
                                         torch.tensor(lens, device=cuda))
    return cfg, params, (ctx.enc_states, ctx.hidden_features, ctx.mask)


def _agree(got, want):
    parts = beam_mega.parting(got, want, NEAR_TIE)
    for b, part in enumerate(parts):
        if part is None:
            torch.testing.assert_close(got[2][b], want[2][b], rtol=1e-5,
                                       atol=1e-4)
    return parts


CASES = {   # name: (B, k, T, H_enc, lens, steps, decoder options)
    "b1_k4": (1, 4, 9, 16, [9], 16, {}),
    "b2_k1_unequal": (2, 1, 9, 16, [9, 4], 16, {}),
    "b2_k16_deep_sp": (2, 16, 9, 16, [7, 9], 16,
                       dict(num_layers_dec=2, lm_hidden_size=24)),
    "b2_k4_penalty": (2, 4, 9, 16, [9, 5], 16, dict(word_ins_penalty=0.5)),
    "b2_k4_eos_rigged": (2, 4, 9, 16, [9, 5], 16, dict(eos_rig=True)),
    "flagship_b2_k4": (2, 4, 64, 512, [64, 40], 120,
                       dict(hidden_size_dec=256, emb_size=256,
                            attention_vec_size=128, lm_hidden_size=256)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain(cuda, name):
    B, k, T, H_enc, lens, steps, opts = CASES[name]
    opts = dict(opts)
    penalty = opts.pop("word_ins_penalty", 0.0)
    cfg, params, args = _setup(cuda, B=B, T=T, H_enc=H_enc, lens=lens,
                               **opts)
    bc = BeamConfig(beam_size=k, max_steps=steps, word_ins_penalty=penalty)
    before = beam_mega.LAUNCHES
    got = beam_mega.beam_decode_mega(params, cfg, bc, *args, trace=True)
    torch.cuda.synchronize()
    assert beam_mega.LAUNCHES == before + 1
    want = beam_mega.beam_decode_mega_reference(params, cfg, bc, *args,
                                                trace=True)
    _agree(got, want)
    assert got[0].shape == (B, steps) and got[0].dtype == torch.long
    if opts.get("eos_rig"):
        assert got[1].tolist() == [1] * B       # [<eos>] only


@pytest.mark.cuda
def test_limits_and_route(cuda):
    """Past the kernel's limits it raises; beam_decode routes B <= 2 with
    k <= 16 to it and everything else to the per-step path."""
    cfg, params, args = _setup(cuda, B=3, T=9, H_enc=16, lens=[9, 9, 4])
    enc, lens = args[0], torch.tensor([9, 9, 4], device=cuda)
    with pytest.raises(ValueError, match="limits"):
        beam_mega.beam_decode_mega(params, cfg, BeamConfig(beam_size=17),
                                   *args)
    for B, k, mega in ((1, 4, True), (2, 16, True), (3, 4, False),
                       (1, 17, False)):
        bc = BeamConfig(beam_size=k, max_steps=8)
        counts = beam_mega.LAUNCHES, dec_step.CELLS_LAUNCHES
        beam.beam_decode(params, cfg, bc, enc[:B], lens[:B])
        torch.cuda.synchronize()
        assert beam_mega.LAUNCHES - counts[0] == int(mega), (B, k)
        assert (dec_step.CELLS_LAUNCHES > counts[1]) == (not mega), (B, k)
    wide = dataclasses.replace(cfg, vocab_size=600)
    params = attn_decoder.init(torch.Generator().manual_seed(0), wide, 16,
                               device=cuda)
    assert not beam.takes_mega(params, BeamConfig(beam_size=16), 1)
