"""The deep decoders' training kernels and the wide LSTM kernels against
their plain PyTorch versions on the card (marker `cuda`; they skip without
a GPU): #8/#9 and #10 with stacked decoder cells, SimpleProjection,
ind_softmax, scheduled sampling and dropout (inter-layer masks included);
#4 in its three forms and #5's wide form at the edges of their routes (H =
1056, 1088, 1280 resident; 1312 and 2048 streamed; B = 1 and 130; T = 1;
steps where every row is invalid), each case held to the route it takes;
the raises for shapes outside a kernel's envelope.

No JAX import, so they also run where JAX is not installed:
    pytest --noconftest -m cuda tests/test_torch_cuda*.py

Tolerances: float32 sums in another order than the plain version's: 1e-4
absolute on forward values of order 1 (1e-4 relative to the largest |h|
for the wide LSTM, whose sums run over up to 2048 terms), and 1e-4
relative to each gradient's largest value.
"""
import numpy as np
import pytest
import torch

from e2e_asr_tpu_torch.config import DecoderConfig
from e2e_asr_tpu_torch.kernels import dec_train, dec_train_gru, lstm_bidir
from e2e_asr_tpu_torch.kernels import lstm_seq
from e2e_asr_tpu_torch.models import attn_decoder

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, *shape, scale=1.0, device="cpu"):
    return torch.tensor((rng.normal(size=shape) * scale).astype(np.float32),
                        device=device)


def _close(got, want, rel=1e-4, names=None):
    for i, (g, w) in enumerate(zip(got, want)):
        scale = max(float(w.abs().max()), 1e-6)
        name = names[i] if names else str(i)
        torch.testing.assert_close(g, w, atol=rel * scale, rtol=0,
                                   msg=lambda m, n=name: f"{n}: {m}")


def deep_case(dev, use_lstm, NL, G, ind, rng, S=6, B=10, D=24, M=16, E=20,
              A=12, V=13, T=7):
    """Decoder weights (`weight_args` of an initialised decoder, lm_hidden
    G: SimpleProjection when G != D) and the fused form's inputs with
    sampling and dropout on."""
    cfg = DecoderConfig(hidden_size_dec=D, num_layers_dec=NL, emb_size=M,
                        vocab_size=V, attention_vec_size=A, lm_hidden_size=G,
                        ind_softmax=ind, use_lstm=use_lstm)
    params = attn_decoder.init(torch.Generator().manual_seed(NL + G), cfg, E,
                               device=dev)
    mod = dec_train if use_lstm else dec_train_gru
    weights = [w.detach().contiguous() for w in mod.weight_args(params, M)]
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

    def keep(*shape):
        return torch.tensor((rng.random(shape) < 0.8).astype(np.float32)
                            / 0.8, device=dev)

    inter = keep(NL - 1, S, B, D) if NL > 1 else None
    x = ([_rand(rng, S, B, 4 * G, device=dev)] if use_lstm
         else [_rand(rng, S, B, 2 * G, device=dev),
               _rand(rng, S, B, G, device=dev)])
    return (weights, _rand(rng, B, T, A, device=dev),
            _rand(rng, B, T, E, device=dev), amask, x, gum,
            flag[:, None].expand(S, B).contiguous(), keep(S, B, G), inter,
            G != D)


# cell, layers, lm_hidden (SimpleProjection when != 24), ind_softmax,
# sampling and dropout on.
DEEP = {"lstm_2_sp_ind": (True, 2, 40, True, True),
        "lstm_3": (True, 3, 24, False, True),
        "lstm_1_sp": (True, 1, 40, False, True),
        "lstm_2_sp_plain": (True, 2, 40, False, False),
        "gru_2_sp_ind": (False, 2, 40, True, True),
        "gru_3": (False, 3, 24, False, True),
        "gru_1_sp": (False, 1, 40, False, True),
        "gru_2_sp_plain": (False, 2, 40, False, False),
        "lstm_8_sp": (True, 8, 40, False, True),     # the kernels' cap
        "gru_8_sp": (False, 8, 40, True, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DEEP))
def test_deep_decoder_kernels(cuda, case):
    """#8/#9 (LSTM) and #10 (GRU) forward and backward against the plain
    version and its autograd, deep and with SimpleProjection, with and
    without sampling and dropout."""
    use_lstm, NL, G, ind, noisy = DEEP[case]
    rng = np.random.default_rng(NL * 7 + G)
    (weights, hf, enc, amask, x, gum, flag, masks, inter,
     sp) = deep_case(cuda, use_lstm, NL, G, ind, rng)
    if not noisy:
        gum = flag = masks = inter = None
    mod = dec_train if use_lstm else dec_train_gru
    run = dec_train.dec_train if use_lstm else dec_train_gru.dec_train_gru
    ref = (dec_train.dec_train_reference if use_lstm
           else dec_train_gru.dec_train_gru_reference)
    leaves = [t.requires_grad_(True) for t in (*weights, hf, enc, *x)]
    counts = (mod.FWD_LAUNCHES, mod.BWD_LAUNCHES)
    got = run(weights, hf, enc, amask, *x, gum, flag, masks, inter, sp=sp)
    dlog = _rand(rng, *got.shape, device=cuda)
    g_got = torch.autograd.grad(got, leaves, dlog)
    torch.cuda.synchronize()
    assert (mod.FWD_LAUNCHES, mod.BWD_LAUNCHES) == (counts[0] + 1,
                                                    counts[1] + 1)
    sampled = None
    if noisy:   # the kernel's run samples what the plain run samples
        sampled = dec_train.sampled_tokens(got.detach(), gum)
        torch.testing.assert_close(sampled, dec_train.sampled_tokens(
            ref(weights, hf, enc, amask, *x, gum, flag, masks, inter,
                sp=sp).detach(), gum))
    want = ref(weights, hf, enc, amask, *x, gum, flag, masks, inter,
               sampled=sampled, sp=sp)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    g_want = [torch.zeros_like(t) if g is None else g
              for t, g in zip(leaves, torch.autograd.grad(
                  want, leaves, dlog, allow_unused=True))]
    _close(g_got, g_want, names=[f"leaf {i}" for i in range(len(leaves))])


@pytest.mark.cuda
@pytest.mark.parametrize("use_lstm", [True, False])
def test_deep_decoder_envelope_raises(cuda, use_lstm):
    """Nine decoder layers (the kernels take 1 to 8) and inter-layer masks
    at one layer raise, naming the shape."""
    rng = np.random.default_rng(3)
    (weights, hf, enc, amask, x, gum, flag, masks, _,
     sp) = deep_case(cuda, use_lstm, 1, 24, False, rng)
    run = dec_train.dec_train if use_lstm else dec_train_gru.dec_train_gru
    if use_lstm:   # a deeper layer: kernel [2D, 4D], bias [4D]
        D = weights[5].shape[0] // 4
        extra = [torch.zeros(2 * D, 4 * D, device=cuda),
                 torch.zeros(4 * D, device=cuda)]
    else:          # wgx, bg, wgh, wcx, bc, wch of a layer of input D
        D = weights[-1].shape[0]
        extra = [torch.zeros(*s, device=cuda) for s in (
            (D, 2 * D), (2 * D,), (D, 2 * D), (D, D), (D,), (D, D))]
    with pytest.raises(ValueError, match="9 decoder layers"):
        run(weights + extra * 8, hf, enc, amask, *x, gum, flag, masks)
    S, B = masks.shape[:2]
    with pytest.raises(ValueError, match="more than one decoder layer"):
        run(weights, hf, enc, amask, *x, gum, flag, masks,
            torch.ones(1, S, B, D, device=cuda))


# (H, T, B, masked): the resident routes of #4 and #5-wide (1056, 1088,
# 1280; B = 130 takes two row tiles, T = 1 no recurrent product, B = 1 one
# row) and their streamed routes (1312, 2048). masked: False, True (ragged
# lengths) or "holes" (ragged, and steps where every row is invalid).
WIDE = [(1088, 40, 16, True), (1280, 24, 128, True), (1280, 12, 16, False),
        (2048, 10, 32, True), (1280, 7, 130, True), (1280, 1, 16, False),
        (1056, 9, 1, "holes"), (1312, 6, 8, True), (1280, 10, 24, "holes")]


def _wide_mask(rng, T, B, masked, device):
    """None, or a [T, B, 1] validity mask of ragged lengths (row 0 full);
    with "holes" also steps 1 and T - 2 invalid for every row."""
    if not masked:
        return None
    lens = rng.integers(1, T + 1, size=B)
    lens[0] = T
    m = (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)
    if masked == "holes":
        m[[1, T - 2]] = 0.0
    return torch.tensor(m[:, :, None], device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("H,T,B,masked", WIDE)
def test_wide_lstm_forward_forms(cuda, H, T, B, masked):
    """#4's inference, masked and training forms against the plain
    version, and the route: H > 1024 never launches #3."""
    rng = np.random.default_rng(H + T)
    x = _rand(rng, T, B, 4 * H, device=cuda)
    w = _rand(rng, H, 4 * H, scale=1.0 / np.sqrt(H), device=cuda)
    mask = _wide_mask(rng, T, B, masked, cuda)
    masked = mask is not None
    before = (lstm_seq.WIDE_LAUNCHES, lstm_seq.WIDE_MASKED_LAUNCHES,
              lstm_seq.WIDE_TRAIN_LAUNCHES, lstm_seq.LAUNCHES,
              lstm_seq.MASKED_LAUNCHES, lstm_seq.TRAIN_LAUNCHES)
    routes = dict(lstm_seq.WIDE_FWD_ROUTES)
    with torch.no_grad():
        h = lstm_seq.lstm_seq(x, w, mask)
    h_t, c_t = lstm_seq.lstm_seq_train(x, w, mask)
    torch.cuda.synchronize()
    after = (lstm_seq.WIDE_LAUNCHES, lstm_seq.WIDE_MASKED_LAUNCHES,
             lstm_seq.WIDE_TRAIN_LAUNCHES, lstm_seq.LAUNCHES,
             lstm_seq.MASKED_LAUNCHES, lstm_seq.TRAIN_LAUNCHES)
    assert np.subtract(after, before).tolist() == [
        int(not masked), int(masked), 1, 0, 0, 0]
    route = "resident" if H <= 1280 else "streamed"
    assert lstm_seq.WIDE_FWD_LAST_PLAN["route"] == route
    assert {k: v - routes[k] for k, v in lstm_seq.WIDE_FWD_ROUTES.items()} == {
        r: 2 * (r == route) for r in routes}
    want_h, want_c = lstm_seq.lstm_seq_reference(x, w, mask, save_c=True)
    _close([h, h_t, c_t], [want_h, want_h, want_c])


@pytest.mark.cuda
@pytest.mark.parametrize("H,T,B,masked", WIDE)
def test_wide_lstm_backward(cuda, H, T, B, masked):
    """#5's wide form and the dW matmul beside it against the plain
    backward, from the plain forward's h and c, on the route its width
    takes; through autograd too."""
    rng = np.random.default_rng(H * 3 + T)
    x = _rand(rng, T, B, 4 * H, device=cuda)
    w = _rand(rng, H, 4 * H, scale=1.0 / np.sqrt(H), device=cuda)
    mask = _wide_mask(rng, T, B, masked, cuda)
    h, c = lstm_seq.lstm_seq_reference(x, w, mask, save_c=True)
    g = _rand(rng, T, B, H, device=cuda)
    before = lstm_seq.WIDE_BWD_LAUNCHES
    routes = dict(lstm_seq.WIDE_BWD_ROUTES)
    got = lstm_seq.lstm_bwd_wide(w, h, c, x, g, mask)
    torch.cuda.synchronize()
    assert lstm_seq.WIDE_BWD_LAUNCHES == before + 1
    route = "resident" if H <= 1280 else "streamed"
    assert lstm_seq.WIDE_BWD_LAST_PLAN["route"] == route
    assert {k: v - routes[k] for k, v in lstm_seq.WIDE_BWD_ROUTES.items()} == {
        r: int(r == route) for r in routes}
    want = lstm_bidir.lstm_bwd_reference(w, h, c, x, g, mask)
    _close(got, want, names=["dx", "dw"])
    xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = lstm_seq.lstm_seq(xs, ws, mask)
    grads = torch.autograd.grad(out, (xs, ws), g)
    assert lstm_seq.WIDE_BWD_LAUNCHES == before + 2
    _close(grads, want, names=["dx", "dw"])


@pytest.mark.cuda
def test_wide_forward_plan_covers_every_unit_once(cuda):
    """#4's route as csrc/lstm_seq_wide.cu chooses it, for every width it
    accepts up to 8192: the resident route's blocks own every unit once,
    in one wave on the card's SMs, each within 232,448 B of shared memory;
    on the H100 W_h stays resident from H = 1056 up to 1280 and is streamed
    above."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for H in range(1056, 8193, 32):
        plan = lstm_seq.wide_fwd_plan(H, cuda.index or 0)
        blocks, units = plan["blocks"], plan["units"]
        assert (blocks - 1) * units < H <= blocks * units, (H, plan)
        if plan["route"] == "resident":
            assert plan["smem"] <= 232448 and blocks <= sms, (H, plan)
        if sms == 132:
            assert plan["route"] == ("resident" if H <= 1280
                                     else "streamed"), H


@pytest.mark.cuda
def test_wide_backward_plan_covers_every_unit_once(cuda):
    """#5-wide's walk as csrc/lstm_seq_wide.cu chooses it, for every width
    it accepts up to 8192: the resident route's clusters of 2 blocks own
    every unit once, all in one wave, each block within 232,448 B of
    shared memory; on the H100 W_h stays resident from H = 1056 up to 1280
    and is streamed above."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for H in range(1056, 8193, 32):
        plan = lstm_seq.wide_bwd_plan(H, cuda.index or 0)
        if plan["route"] == "resident":
            q, n, u = plan["cluster"], plan["clusters"], plan["units"]
            assert q == 2 and u == 10, (H, plan)
            assert (n - 1) * q * u < H <= n * q * u, (H, plan)
            assert n <= plan["held"] and plan["smem"] <= 232448, (H, plan)
        if sms == 132:
            assert plan["route"] == ("resident" if H <= 1280
                                     else "streamed"), H


@pytest.mark.cuda
@pytest.mark.parametrize("H", [1280, 2048])
def test_wide_lstm_is_bitwise_deterministic(cuda, H):
    """Two calls of #4 (either route) give the same h and c, and two of #5's
    wide form with its dW the same dx and dW_h."""
    rng = np.random.default_rng(H + 1)
    T, B = 6, 24
    x = _rand(rng, T, B, 4 * H, device=cuda)
    w = _rand(rng, H, 4 * H, scale=1.0 / np.sqrt(H), device=cuda)
    first, second = (lstm_seq.lstm_seq_train(x, w) for _ in range(2))
    g = _rand(rng, T, B, H, device=cuda)
    bwd = [lstm_seq.lstm_bwd_wide(w, *first, x, g) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert all(torch.equal(a, b) for a, b in zip(*bwd))


@pytest.mark.cuda
def test_wide_lstm_refuses_a_width_off_its_tiles(cuda):
    """H > 1024 that is no multiple of 32 raises ValueError naming H, in
    both directions; nothing falls back to another kernel."""
    T, B, H = 3, 2, 1036
    x = torch.zeros(T, B, 4 * H, device=cuda)
    w = torch.zeros(H, 4 * H, device=cuda)
    with pytest.raises(ValueError, match="H=1036"):
        lstm_seq.lstm_seq(x, w)
    h = torch.zeros(T, B, H, device=cuda)
    with pytest.raises(ValueError, match="H=1036"):
        lstm_seq.lstm_bwd_wide(w, h, h, x, h)


@pytest.mark.cuda
def test_narrow_backward_refuses_wide(cuda):
    """#5 (one block per chain) takes H <= 1024: handed H = 1088 it raises
    ValueError naming 'Wide layers' before the launch; the route never
    hands it one."""
    rng = np.random.default_rng(5)
    T, B, H = 3, 2, 1088
    x = _rand(rng, T, B, 4 * H, device=cuda)
    w = _rand(rng, H, 4 * H, scale=0.03, device=cuda)
    h, c = lstm_seq.lstm_seq_reference(x, w, save_c=True)
    with pytest.raises(ValueError, match="Wide layers"):
        lstm_bidir.lstm_bwd(w, h, c, x, torch.ones_like(h))
        torch.cuda.synchronize()
