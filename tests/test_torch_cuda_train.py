"""The training kernels of e2e_asr_tpu_torch against their plain PyTorch
versions on the card (marker `cuda`; they skip without a GPU): kernel A's
training form and its backward (both directions in one launch, and one
direction with a carry mask), the decoder's training forward and backward,
and the whole ASR step on the card against the same step on the CPU.

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
from e2e_asr_tpu_torch.core import checkpoint
from e2e_asr_tpu_torch.kernels import dec_train, lstm_bidir
from e2e_asr_tpu_torch.models import seq2seq
from e2e_asr_tpu_torch.train import step
from test_torch_cuda import fwd_route

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


def _lstm_inputs(rng, T, B, H, dev):
    lens = rng.integers(1, T + 1, size=B)
    lens[0] = T
    mask = (np.arange(T)[:, None] >= T - lens[None, :]).astype(np.float32)
    return [_rand(rng, T, B, 4 * H, device=dev),
            _rand(rng, T, B, 4 * H, device=dev),
            _rand(rng, H, 4 * H, scale=0.1, device=dev),
            _rand(rng, H, 4 * H, scale=0.1, device=dev),
            torch.tensor(mask[:, :, None], device=dev)]


# (T, B, H, masked): both sides of the backward's resident / streamed route
# (H = 40, 256 | 320, 1024) and of the forward's (H <= 320 | 1024; at H = 4
# and 40 some blocks of a cluster own padding units or none), ragged row
# groups (B = 1, 17, 128; B = 300 walks 32 rows a cluster in the backward,
# one thread a product lane; B = 5 leaves the forward's second row group
# past B), T = 1, the
# one-direction form with and without its carry mask, and T*B = 8,454,015
# rows, more than 65535 of the gate product's 128-row tiles.
LSTM_CASES = [(64, 5, 40, True), (16, 8, 256, True), (12, 17, 256, False),
              (1, 128, 256, True), (10, 1, 40, False), (6, 17, 320, True),
              (5, 128, 320, False), (4, 3, 1024, True), (1, 1, 1024, False),
              (3, 300, 256, True), (129, 65535, 4, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H,masked", LSTM_CASES)
def test_lstm_training_forward_and_backward(cuda, T, B, H, masked):
    rng = np.random.default_rng(0)
    xf, xb, wf, wb, mask = _lstm_inputs(rng, T, B, H, cuda)
    before = lstm_bidir.TRAIN_LAUNCHES
    fwd_routes = dict(lstm_bidir.FWD_ROUTES)
    fwd = lstm_bidir.lstm_seq_bidir_train(xf, xb, wf, wb, mask)
    torch.cuda.synchronize()
    assert lstm_bidir.TRAIN_LAUNCHES == before + 1
    route = fwd_route(H)
    assert lstm_bidir.FWD_LAST_PLAN["route"] == route
    assert {k: lstm_bidir.FWD_ROUTES[k] - fwd_routes[k]
            for k in fwd_routes} == {r: int(r == route) for r in fwd_routes}
    want = lstm_bidir.lstm_seq_bidir_reference(xf, xb, wf, wb, mask,
                                               save_c=True)
    for g, w in zip(fwd, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0)
    h_fw, h_bw, c_fw, c_bw = want
    g_fw, g_bw = _rand(rng, T, B, H, device=cuda), _rand(rng, T, B, H,
                                                          device=cuda)
    one_mask = mask if masked else None
    counts = (lstm_bidir.BWD_LAUNCHES, lstm_bidir.BWD_SINGLE_LAUNCHES)
    routes = dict(lstm_bidir.BWD_ROUTES)
    both = lstm_bidir.lstm_bidir_bwd(wf, wb, h_fw, c_fw, xf, g_fw, h_bw, c_bw,
                                     xb, g_bw, mask)
    single = lstm_bidir.lstm_bwd(wb, h_bw, c_bw, xb, g_bw, one_mask)
    torch.cuda.synchronize()
    assert (lstm_bidir.BWD_LAUNCHES,
            lstm_bidir.BWD_SINGLE_LAUNCHES) == (counts[0] + 1, counts[1] + 1)
    route = "resident" if H <= 296 else "streamed"
    assert lstm_bidir.BWD_LAST_PLAN["route"] == route
    assert {k: lstm_bidir.BWD_ROUTES[k] - routes[k] for k in routes} == {
        r: 2 * (r == route) for r in routes}
    ref_fw = lstm_bidir.lstm_bwd_reference(wf, h_fw, c_fw, xf, g_fw)
    ref_bw = lstm_bidir.lstm_bwd_reference(wb, h_bw, c_bw, xb, g_bw, mask)
    _close(both, (*ref_fw, *ref_bw))
    _close(single, lstm_bidir.lstm_bwd_reference(wb, h_bw, c_bw, xb, g_bw,
                                                 one_mask))


@pytest.mark.cuda
@pytest.mark.parametrize("H", [256, 320])
def test_lstm_backward_is_bitwise_deterministic(cuda, H):
    """Two calls of either backward form on the same inputs give the same
    bits (dx, dW_h): fixed-order sums, no atomics, on either route."""
    rng = np.random.default_rng(H)
    T, B = 9, 33
    xf, xb, wf, wb, mask = _lstm_inputs(rng, T, B, H, cuda)
    h_fw, h_bw, c_fw, c_bw = lstm_bidir.lstm_seq_bidir_train(xf, xb, wf, wb,
                                                             mask)
    g_fw, g_bw = _rand(rng, T, B, H, device=cuda), _rand(rng, T, B, H,
                                                          device=cuda)
    args = (wf, wb, h_fw, c_fw, xf, g_fw, h_bw, c_bw, xb, g_bw, mask)
    one = (wb, h_bw, c_bw, xb, g_bw, mask)
    for run in (lambda: lstm_bidir.lstm_bidir_bwd(*args),
                lambda: lstm_bidir.lstm_bwd(*one)):
        first, second = run(), run()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_lstm_backward_plan_covers_every_unit_and_row_once(cuda):
    """The walk's plan as csrc/lstm_bidir_bwd.cu chooses it, for every H
    the backward accepts: the 8 blocks of a cluster own ceil(H / 8) units
    each, so every unit and gate column once; the row groups cover B once;
    a block fits 232,448 B of shared memory and holds its product lanes (4
    rows x 4 units each, S threads a lane) and its (row, unit) pairs, two
    a lane; W_h stays resident exactly up to H = 296; at the flagship's
    B = 128 both directions' clusters fit the card at once up to H = 256."""
    for H in range(1, lstm_bidir.MAX_H + 1):
        for B, n_dirs in ((1, 1), (17, 2), (128, 2), (128, 1), (4096, 2)):
            plan = lstm_bidir.bwd_plan(H, B, n_dirs, cuda.index or 0)
            U, Rg, groups = plan["U"], plan["Rg"], plan["groups"]
            lanes = Rg // 4 * 2 * U
            assert 8 * (U - 1) < H <= 8 * U, (H, plan)
            assert Rg % 4 == 0 and (groups - 1) * Rg < B <= groups * Rg
            assert plan["smem"] <= 232448 and Rg * U <= 2 * lanes
            assert plan["S"] * lanes <= plan["thr"], (H, B, plan)
            assert plan["route"] == ("resident" if H <= 296 else "streamed")
            assert plan["S"] == 1 or plan["route"] == "resident"
            if H <= 256 and B == 128:
                assert n_dirs * groups <= plan["clusters"], (H, plan)


# B = 8 walks clusters of 16 blocks at the flagship width, B = 33 clusters
# of 8 (test_lstm_forward_plan_covers_every_unit_and_row_once).
@pytest.mark.cuda
@pytest.mark.parametrize("B", [8, 33])
@pytest.mark.parametrize("H", [256, 400])
def test_lstm_forward_is_bitwise_deterministic(cuda, H, B):
    """Two calls of either forward form on the same inputs give the same
    bits (h, and c in the training form), on either route (H = 256
    resident, 400 streamed) and on clusters of 16 or 8 blocks: each gate's
    sum runs over the depth in a fixed order, with no atomics."""
    rng = np.random.default_rng(H + B)
    args = _lstm_inputs(rng, 9, B, H, cuda)
    for save_c in (False, True):
        first = lstm_bidir.fwd_cuda(*args, save_c=save_c)
        second = lstm_bidir.fwd_cuda(*args, save_c=save_c)
        torch.cuda.synchronize()
        plan = lstm_bidir.FWD_LAST_PLAN
        assert plan["route"] == fwd_route(H)
        if H == 256:
            assert plan["cluster"] == (16 if B == 8 else 8), plan
        assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_lstm_forward_plan_covers_every_unit_and_row_once(cuda):
    """The forward walk's plan as csrc/lstm_bidir.cu chooses it, for every
    H the forward accepts: the blocks of a cluster (16 where 4 rows a
    cluster put the launch on the card at once, else 8) own ceil(H /
    blocks) units each, so every unit and gate column once; the row groups
    cover B once; a block fits 232,448 B of shared memory and holds its
    product lanes (RL rows x 1 unit each: one row where that fits, else 4)
    within 640 threads, S threads a lane as the one-block chain it replaced
    sliced the depth (4 up to H = 256); W_h stays resident exactly up to H
    = 320; every cluster of the launch fits the card at once at the
    flagship's B = 128 up to H = 256, and at H = 256 the serving shape's B
    = 8 walks 4 rows a cluster of 16 blocks, B = 33 and 128 clusters of
    8."""
    index = cuda.index or 0
    for H in range(1, lstm_bidir.MAX_H + 1):
        for B in (1, 8, 17, 33, 128, 4096, 65535):
            plan = lstm_bidir.fwd_plan(H, B, index)
            n = plan["cluster"]
            U, Rg, groups = plan["U"], plan["Rg"], plan["groups"]
            lanes = Rg // plan["RL"] * U
            assert n == 8 or (n == 16 and Rg == 4 and 2 * groups
                              <= plan["clusters"]), (H, B, plan)
            assert n * (U - 1) < H <= n * U, (H, plan)
            assert Rg % 4 == 0 and (groups - 1) * Rg < B <= groups * Rg
            assert plan["smem"] <= 232448, (H, B, plan)
            assert plan["S"] * lanes <= plan["thr"] <= 640, (H, B, plan)
            one_a_lane = (plan["S"] * Rg * U + 31) // 32 * 32 <= 640
            assert plan["RL"] == (1 if one_a_lane else 4), (H, B, plan)
            assert plan["thr"] % 32 == 0
            assert plan["S"] == max(1, min(4, 1024 // (-(-H // 32) * 32)))
            assert plan["route"] == fwd_route(H)
            if H <= 256 and B == 128:
                assert 2 * groups <= plan["clusters"], (H, plan)
            if H == 256 and B in (8, 33, 128):
                assert n == (16 if B == 8 else 8), plan
            if H == 256 and B in (8, 128):
                assert Rg == (4 if B == 8 else 20), plan


def _dec_inputs(rng, dev, S=7, B=12, G=40, D=40, M=24, E=48, A=20, V=11,
                T=9):
    """Decoder weights and inputs of the fused form at a small shape."""
    w = lambda *s: _rand(rng, *s, scale=0.3, device=dev)  # noqa: E731
    weights = [w(V, 4 * G), w(G, 4 * G), w(G + E, M), w(M), w(M + D, 4 * D),
               w(4 * D), w(D, A), w(A), w(A), w(D + E, D), w(D), w(D, V),
               w(V)]
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
            _rand(rng, S, B, 4 * G, device=dev), gum,
            flag[:, None].expand(S, B).contiguous(), masks)


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", [False, True])
def test_dec_train_kernels(cuda, sampling):
    rng = np.random.default_rng(1)
    weights, hf, enc, amask, tlmx, gum, flag, masks = _dec_inputs(rng, cuda)
    if not sampling:
        gum = flag = None
    leaves = [t.requires_grad_(True) for t in (*weights, hf, enc, tlmx)]
    counts = (dec_train.FWD_LAUNCHES, dec_train.BWD_LAUNCHES)
    got = dec_train.dec_train(weights, hf, enc, amask, tlmx, gum, flag, masks)
    dlog = _rand(rng, *got.shape, device=cuda)
    g_got = torch.autograd.grad(got, leaves, dlog)
    torch.cuda.synchronize()
    assert (dec_train.FWD_LAUNCHES, dec_train.BWD_LAUNCHES) == (
        counts[0] + 1, counts[1] + 1)
    sampled = (dec_train.sampled_tokens(got.detach(), gum) if sampling
               else None)
    want = dec_train.dec_train_reference(weights, hf, enc, amask, tlmx, gum,
                                         flag, masks)
    if sampling:   # the kernel's run samples what the plain run samples
        torch.testing.assert_close(
            sampled, dec_train.sampled_tokens(want.detach(), gum))
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    g_want = [torch.zeros_like(t) if g is None else g
              for t, g in zip(leaves, torch.autograd.grad(
                  want, leaves, dlog, allow_unused=True))]
    for name, g, w in zip((*dec_train.W_NAMES, "hf", "enc", "tlmx"), g_got,
                          g_want):
        scale = max(float(w.abs().max()), 1e-6)
        torch.testing.assert_close(g, w, atol=1e-4 * scale, rtol=0,
                                   msg=lambda m, n=name: f"{n}: {m}")


def _small_cfg() -> Seq2SeqConfig:
    return Seq2SeqConfig(
        tasks=["char"], num_layers={"char": 3}, max_output={"char": 10},
        encoder=EncoderConfig(hidden_size=32, out_prob=0.8),
        decoders={"char": DecoderConfig(
            hidden_size_dec=32, emb_size=24, vocab_size=13,
            attention_vec_size=16, lm_hidden_size=32, samp_prob=0.0,
            out_prob_dec=0.8, max_output=10)},
        feat_length=10)


@pytest.mark.cuda
def test_asr_step_on_the_card_matches_the_cpu(cuda):
    """One asr_step (teacher forcing, dropout on with the same masks) on
    the card and on the CPU: loss, every gradient, params after the step."""
    cfg, lm_cfg = _small_cfg(), LMConfig()
    rng = np.random.default_rng(2)
    B, T, L = 6, 40, 8
    lens = rng.integers(10, T + 1, size=B)
    lens[0] = T
    char_len = rng.integers(2, L, size=B)
    char = np.zeros((B, L), np.int64)
    char[:, 0] = 1
    for i, n in enumerate(char_len):
        char[i, 1:n] = rng.integers(3, 13, size=n - 1)
        char[i, n] = 2
    batch = {"logmel": rng.normal(size=(B, T, 10)).astype(np.float32),
             "logmel_len": lens, "char": char, "char_len": char_len}
    gen = torch.Generator().manual_seed(0)
    params = seq2seq.init(gen, cfg, device="cpu")
    noise = {"encoder": {d: torch.rand(t, B, 64, generator=gen) < 0.8
                         for d, t in ((1, T), (2, T // 2), (3, T // 4))},
             "char": (None, None,
                      (torch.rand(L - 1, B, 32, generator=gen) < 0.8) / 0.8,
                      ())}
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
