"""The GRU kernels of e2e_asr_tpu_torch against their plain PyTorch versions
on the card (marker `cuda`; they skip without a GPU): kernel #6 (one
direction with and without the carry mask, both directions in one launch;
inference and training forms), kernel #7 (one and both directions), kernel
#10's forward and backward at a char-like and a phone-like vocabulary, the
whole GRU-family ASR step (char + phone) on the card against the CPU, and
the GRU decode: kernel #11's GRU branch (one layer, and two with
SimpleProjection), kernel #15's GRU branch (agreeing, or parting at a
near-tie of 1e-3 as tests/test_torch_cuda_beam_mega.py's cases), and a
greedy and a beam decode of a GRU decoder on the card against the CPU.

These files import no JAX, so they also run where JAX is not installed:
    pytest --noconftest -m cuda tests/test_torch_cuda*.py

Tolerances: float32 sums in another order than the plain version's over
recurrences of up to 64 steps: 1e-4 absolute on values of order 1, and
1e-4 relative to each gradient's largest value.
"""
import numpy as np
import pytest
import torch

from e2e_asr_tpu_torch.config import (DecoderConfig, EncoderConfig, LMConfig,
                                      Seq2SeqConfig)
from e2e_asr_tpu_torch.config import BeamConfig
from e2e_asr_tpu_torch.core import checkpoint
from e2e_asr_tpu_torch.eval import beam
from e2e_asr_tpu_torch.kernels import (beam_mega, dec_step, dec_train,
                                       dec_train_gru, gru_seq)
from e2e_asr_tpu_torch.models import attn_decoder, seq2seq
from e2e_asr_tpu_torch.train import step
from test_torch_cuda_beam_mega import _agree, _setup

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


def _close(got, want, rel=1e-4):
    for g, w in zip(got, want):
        scale = max(float(w.abs().max()), 1e-6)
        torch.testing.assert_close(g, w, atol=rel * scale, rtol=0)


def _direction(rng, T, B, H, dev, masked):
    """(gates_x, cand_x, w_gh, w_ch, mask|None) of one direction."""
    lens = rng.integers(1, T + 1, size=B)
    lens[0] = T
    mask = (np.arange(T)[:, None] >= T - lens[None, :]).astype(np.float32)
    return (_rand(rng, T, B, 2 * H, device=dev), _rand(rng, T, B, H,
                                                        device=dev),
            _rand(rng, H, 2 * H, scale=0.1, device=dev),
            _rand(rng, H, H, scale=0.1, device=dev),
            torch.tensor(mask[:, :, None], device=dev) if masked else None)


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(64, 5, 40), (16, 8, 256)])
def test_gru_forward_forms(cuda, T, B, H):
    """#6: one direction without and with the mask, both directions in one
    launch; the inference and the training form."""
    rng = np.random.default_rng(0)
    plain = _direction(rng, T, B, H, cuda, False)
    masked = _direction(rng, T, B, H, cuda, True)
    counts = (gru_seq.SEQ_LAUNCHES, gru_seq.MASKED_LAUNCHES,
              gru_seq.LAUNCHES, gru_seq.TRAIN_LAUNCHES)
    got = [gru_seq.gru_seq(*plain), gru_seq.gru_seq(*masked),
           *gru_seq.gru_seq_bidir(*plain[:2], *masked[:2], *plain[2:4],
                                  *masked[2:4], masked[4])]
    train = [*gru_seq.gru_seq_train(*masked),
             *[t for d in gru_seq.gru_seq_bidir_train(
                 *plain[:2], *masked[:2], *plain[2:4], *masked[2:4],
                 masked[4]) for t in d]]
    torch.cuda.synchronize()
    assert (gru_seq.SEQ_LAUNCHES, gru_seq.MASKED_LAUNCHES, gru_seq.LAUNCHES,
            gru_seq.TRAIN_LAUNCHES) == (counts[0] + 1, counts[1] + 1,
                                        counts[2] + 1, counts[3] + 2)
    ref_plain = gru_seq.gru_seq_reference(*plain, save=True)
    ref_masked = gru_seq.gru_seq_reference(*masked, save=True)
    for g, w in zip(got, [ref_plain[0], ref_masked[0], ref_plain[0],
                          ref_masked[0]]):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0)
    for g, w in zip(train, [*ref_masked, *ref_plain, *ref_masked]):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(64, 5, 40), (16, 8, 256)])
def test_gru_backward(cuda, T, B, H):
    """#7: one direction without and with the mask, and both directions in
    one launch, from the plain forward's saves."""
    rng = np.random.default_rng(1)
    dirs = []
    for masked in (False, True):
        gx, cx, wg, wc, mask = _direction(rng, T, B, H, cuda, masked)
        h, ru, c = gru_seq.gru_seq_reference(gx, cx, wg, wc, mask, save=True)
        dirs.append((wg, wc, h, ru, c, _rand(rng, T, B, H, device=cuda),
                     mask))
    counts = (gru_seq.BWD_SINGLE_LAUNCHES, gru_seq.BWD_LAUNCHES)
    single = [gru_seq.gru_bwd(*d) for d in dirs]
    both = gru_seq.gru_bidir_bwd(*dirs)
    torch.cuda.synchronize()
    assert (gru_seq.BWD_SINGLE_LAUNCHES, gru_seq.BWD_LAUNCHES) == (
        counts[0] + 2, counts[1] + 1)
    for d, got, pair in zip(dirs, single, both):
        want = gru_seq.gru_bwd_reference(*d)
        _close(got, want)
        _close(pair, want)


def _gru_dec_inputs(rng, dev, V, S=7, B=12, G=40, D=40, M=24, E=48, A=20,
                    T=9):
    """GRU decoder weights and inputs of the fused form at a small shape."""
    w = lambda *s: _rand(rng, *s, scale=0.3, device=dev)  # noqa: E731
    weights = [w(V, 2 * G), w(V, G), w(G, 2 * G), w(G, G), w(G + E, M), w(M),
               w(D, A), w(A), w(A), w(D + E, D), w(D), w(D, V), w(V),
               w(M, 2 * D), w(2 * D), w(D, 2 * D), w(M, D), w(D), w(D, D)]
    lens = rng.integers(1, T + 1, size=B)
    lens[0] = T
    amask = torch.tensor((np.arange(T)[None, :] < lens[:, None]).astype(
        np.float32), device=dev)
    u = torch.tensor(rng.uniform(1e-6, 1, size=(S, B, V)).astype(np.float32),
                     device=dev)
    gum = -torch.log(-torch.log(u))
    gum[0] = 0
    flag = torch.tensor((rng.random(S) < 0.5).astype(np.float32), device=dev)
    flag[0] = 0
    masks = torch.tensor((rng.random((S, B, G)) < 0.8).astype(np.float32)
                         / 0.8, device=dev)
    return (weights, _rand(rng, B, T, A, device=dev),
            _rand(rng, B, T, E, device=dev), amask,
            _rand(rng, S, B, 2 * G, device=dev),
            _rand(rng, S, B, G, device=dev), gum,
            flag[:, None].expand(S, B).contiguous(), masks)


@pytest.mark.cuda
@pytest.mark.parametrize("V,sampling", [(40, False), (40, True),
                                        (46, True)])
def test_dec_train_gru_kernels(cuda, V, sampling):
    """#10 forward and backward against the plain version and autograd."""
    rng = np.random.default_rng(V)
    weights, hf, enc, amask, tgx, tcx, gum, flag, masks = _gru_dec_inputs(
        rng, cuda, V)
    if not sampling:
        gum = flag = None
    leaves = [t.requires_grad_(True) for t in (*weights, hf, enc, tgx, tcx)]
    counts = (dec_train_gru.FWD_LAUNCHES, dec_train_gru.BWD_LAUNCHES)
    got = dec_train_gru.dec_train_gru(weights, hf, enc, amask, tgx, tcx, gum,
                                      flag, masks)
    dlog = _rand(rng, *got.shape, device=cuda)
    g_got = torch.autograd.grad(got, leaves, dlog)
    torch.cuda.synchronize()
    assert (dec_train_gru.FWD_LAUNCHES, dec_train_gru.BWD_LAUNCHES) == (
        counts[0] + 1, counts[1] + 1)
    want = dec_train_gru.dec_train_gru_reference(
        weights, hf, enc, amask, tgx, tcx, gum, flag, masks)
    if sampling:   # the kernel's run samples what the plain run samples
        torch.testing.assert_close(
            dec_train.sampled_tokens(got.detach(), gum),
            dec_train.sampled_tokens(want.detach(), gum))
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    g_want = [torch.zeros_like(t) if g is None else g
              for t, g in zip(leaves, torch.autograd.grad(
                  want, leaves, dlog, allow_unused=True))]
    names = (*dec_train_gru.W_NAMES, *dec_train_gru.LAYER_NAMES, "hf", "enc",
             "tgx", "tcx")
    assert len(names) == len(leaves)
    for name, g, w in zip(names, g_got, g_want):
        scale = max(float(w.abs().max()), 1e-6)
        torch.testing.assert_close(g, w, atol=1e-4 * scale, rtol=0,
                                   msg=lambda m, n=name: f"{n}: {m}")


@pytest.mark.cuda
def test_gru_asr_step_on_the_card_matches_the_cpu(cuda):
    """One char + phone asr_step of the GRU family (teacher forcing,
    dropout on with the same masks) on the card and on the CPU: loss, every
    gradient, params after the step."""
    def dec(vocab):
        return DecoderConfig(hidden_size_dec=32, emb_size=24,
                             vocab_size=vocab, attention_vec_size=16,
                             lm_hidden_size=32, samp_prob=0.0,
                             out_prob_dec=0.8, max_output=10, use_lstm=False)

    cfg = Seq2SeqConfig(
        tasks=["char", "phone"], num_layers={"char": 3, "phone": 2},
        max_output={"char": 10, "phone": 10},
        encoder=EncoderConfig(hidden_size=32, out_prob=0.8, use_lstm=False),
        decoders={"char": dec(13), "phone": dec(11)}, avg=True,
        feat_length=10)
    lm_cfg = LMConfig()
    rng = np.random.default_rng(2)
    B, T, L = 6, 40, 8
    lens = rng.integers(10, T + 1, size=B)
    lens[0] = T
    batch = {"logmel": rng.normal(size=(B, T, 10)).astype(np.float32),
             "logmel_len": lens}
    for task, vocab in (("char", 13), ("phone", 11)):
        task_len = rng.integers(2, L, size=B)
        ids = np.zeros((B, L), np.int64)
        ids[:, 0] = 1
        for i, n in enumerate(task_len):
            ids[i, 1:n] = rng.integers(3, vocab, size=n - 1)
            ids[i, n] = 2
        batch[task], batch[f"{task}_len"] = ids, task_len
    gen = torch.Generator().manual_seed(0)
    params = seq2seq.init(gen, cfg, device="cpu")
    noise = {"encoder": {d: torch.rand(t, B, 64, generator=gen) < 0.8
                         for d, t in ((1, T), (2, T // 2), (3, T // 4))}}
    for task in cfg.tasks:
        noise[task] = (None, None, (torch.rand(L - 1, B, 32, generator=gen)
                                    < 0.8) / 0.8, ())
    out = {}
    for dev in ("cpu", cuda):
        asr_step, _ = step.make_train_step(cfg, lm_cfg, device=dev)
        state = step.create_state(params, cfg, lm_cfg, device=dev)
        loss, _, grads = asr_step.loss_and_grads(state.params, batch, None,
                                                 noise)
        new_state, _ = asr_step(state, batch, None, noise)
        out[str(dev)] = (float(loss), checkpoint.named_from_params(grads),
                         checkpoint.named_from_params(new_state.params))
    (loss_c, g_c, p_c), (loss_g, g_g, p_g) = out["cpu"], out["cuda"]
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    for name, w in g_c.items():
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(g_g[name], w, atol=1e-4 * scale, rtol=0,
                                   err_msg=name)
        big = np.abs(w) > max(1e-2 * scale, 1e-6)
        np.testing.assert_allclose(p_g[name][big], p_c[name][big], atol=1e-6,
                                   rtol=0, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("N,layers,lm_hidden", [(32, 1, 256), (5, 2, 48)])
def test_cells_fused_gru(cuda, N, layers, lm_hidden):
    """#11's GRU branch: N = 32 rows at the flagship widths, and 5 rows of
    two layers with SimpleProjection."""
    H = 256 if N == 32 else 32
    cfg = DecoderConfig(hidden_size_dec=H, emb_size=H, vocab_size=40,
                        attention_vec_size=H // 2, lm_hidden_size=lm_hidden,
                        num_layers_dec=layers, use_lstm=False)
    params = attn_decoder.init(torch.Generator().manual_seed(N), cfg, 2 * H,
                               device=cuda)
    assert ("simple_proj" in params) == (lm_hidden != H)
    rng = np.random.default_rng(N)
    args = (params, _rand(rng, N, H, device=cuda),
            _rand(rng, N, 2 * H, scale=0.3, device=cuda),
            _rand(rng, N, lm_hidden, scale=0.5, device=cuda),
            tuple(_rand(rng, N, H, scale=0.5, device=cuda)
                  for _ in range(layers)))
    counts = dec_step.CELLS_LAUNCHES, dec_step.CELLS_GRU_LAUNCHES
    lm, dec, y = dec_step.cells_fused(*args, use_lstm=False)
    torch.cuda.synchronize()
    assert (dec_step.CELLS_LAUNCHES, dec_step.CELLS_GRU_LAUNCHES) == (
        counts[0], counts[1] + 1)
    want_lm, want_dec, want_y = dec_step.cells_fused_reference(
        *args, use_lstm=False)
    for g, w in zip((lm, *dec, y), (want_lm, *want_dec, want_y)):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,k,lens,opts", [
    (1, 4, [9], {}), (2, 3, [9, 5], dict(num_layers_dec=2,
                                         lm_hidden_size=24)),
    (2, 4, [9, 5], dict(eos_rig=True))])
def test_beam_mega_gru(cuda, B, k, lens, opts):
    """#15's GRU branch against its plain version: one launch a search."""
    cfg, params, args = _setup(cuda, B=B, T=9, H_enc=16, lens=lens,
                               use_lstm=False, **opts)
    bc = BeamConfig(beam_size=k, max_steps=16)
    counts = beam_mega.LAUNCHES, beam_mega.GRU_LAUNCHES
    got = beam_mega.beam_decode_mega(params, cfg, bc, *args, trace=True)
    torch.cuda.synchronize()
    assert (beam_mega.LAUNCHES, beam_mega.GRU_LAUNCHES) == (counts[0],
                                                            counts[1] + 1)
    _agree(got, beam_mega.beam_decode_mega_reference(params, cfg, bc, *args,
                                                     trace=True))
    if opts.get("eos_rig"):
        assert got[1].tolist() == [1] * B


@pytest.mark.cuda
def test_gru_decode_on_the_card_matches_the_cpu(cuda):
    """Greedy (#11 GRU, the attention, #12) and per-step beam (#11 GRU,
    #12, #14) decodes of a GRU decoder: the card's ids equal the CPU's."""
    cfg, params, args = _setup(cuda, B=3, T=9, H_enc=16, lens=[9, 6, 3],
                               use_lstm=False)
    enc, lens = args[0], torch.tensor([9, 6, 3], device=cuda)
    cpu = checkpoint.to_device(params, "cpu")
    go = torch.ones(3, dtype=torch.long)
    bc = BeamConfig(beam_size=3, max_steps=12)
    before = dec_step.CELLS_GRU_LAUNCHES
    greedy = attn_decoder.apply_infer_early(params, cfg, go.to(cuda), enc,
                                            lens, max_output=12)
    steps = beam.beam_decode_steps(params, cfg, bc, enc, lens)
    torch.cuda.synchronize()
    assert dec_step.CELLS_GRU_LAUNCHES > before
    torch.testing.assert_close(greedy.cpu(), attn_decoder.apply_infer_early(
        cpu, cfg, go, enc.cpu(), lens.cpu(), max_output=12))
    want = beam.beam_decode_steps(cpu, cfg, bc, enc.cpu(), lens.cpu())
    for g, w in zip(steps[:2], want[:2]):
        torch.testing.assert_close(g.cpu(), w)
    torch.testing.assert_close(steps[2].cpu(), want[2], atol=1e-4, rtol=0)
