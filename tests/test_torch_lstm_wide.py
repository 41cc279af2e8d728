"""Port parity for the wide unidirectional LSTM on the CPU: kernel #4 (the
forward that streams W_h, JAX's `_fwd_seq_chunked`) and #5's wide form
(JAX's `_bwd_seq` with `emit_dw=False`, dW_h one matmul outside the
kernel), whose wrappers run their plain versions here; the route by width;
the LM task with SimpleProjection.

- `lstm_seq_reference` against `_fwd_seq_chunked` in interpret mode in its
  inference, masked and training (`save_c`) forms, at H = 16 (one [C, 4H]
  tile of W_h), 24 and 40 (three and five tiles: JAX streams them), one
  JAX compile per width;
- `lstm_bwd_wide` (on the CPU `lstm_bwd_reference`) against `_bwd_seq`
  with its backward choice pinned to the no-dW form (the one JAX takes at
  H = 1280), dx_proj and dW_h, masked and not;
- `wide_dw` (the matmul beside #5's wide form) against the plain
  backward's dW_h;
- the route: autograd takes #5's wide form above H = 1024 and #5 up to
  it, and a launch counts on #4's counters above H = 1024;
- `rnn_lm.loss` and one LM step with SimpleProjection (lm_hidden 12 over
  a decoder of 8) against JAX's.

Tolerances (float32, sums in other orders): h, c and dx_proj 1e-5
absolute (values of order 1), dW_h and gradients 1e-4 relative to the
largest value, the loss 1e-5 relative, params after the step 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_tpu.config import LMConfig
from e2e_asr_tpu.core import checkpoint as jckpt
from e2e_asr_tpu.models import rnn_lm as jrnn_lm
from e2e_asr_tpu.ops import lstm_pallas
from e2e_asr_tpu.train import step as jstep
from e2e_asr_tpu_torch.core import checkpoint, rnn
from e2e_asr_tpu_torch.kernels import lstm_bidir, lstm_seq
from e2e_asr_tpu_torch.models import rnn_lm
from e2e_asr_tpu_torch.train import step
from tests.test_torch_lm import B as LM_B
from tests.test_torch_lm import T_LM, jax_mask, lm_batch
from tests.test_torch_train_step import (V, assert_leaves_close, init_both,
                                         quick_jit, train_cfg)

torch.set_num_threads(1)
T, B = 5, 3
WIDTHS = [16, 24, 40]                       # 1, 3 and 5 tiles of W_h
FORMS = ["inference", "masked", "train", "train_masked"]


def lstm_case(H, seed=0):
    """x_proj [T,B,4H], W_h [H,4H], a [T,B,1] carry mask with a padded
    tail (rows of lengths 5, 3, 1) and an output gradient, as numpy."""
    rng = np.random.default_rng(seed + H)
    x = rng.normal(size=(T, B, 4 * H)).astype(np.float32)
    w = (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    lens = np.array([T, 3, 1])
    mask = (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)
    g = rng.normal(size=(T, B, H)).astype(np.float32)
    return x, w, mask[:, :, None], g


_FWD = {}


def chunked_forms(H):
    """The four forms of JAX's weight-streaming forward at width H, one
    compile for all: {form: (h,) or (h, c)}."""
    if H not in _FWD:
        x, w, mask, _ = lstm_case(H)

        def run(x, w, mask):
            f = lstm_pallas._fwd_seq_chunked
            return {"inference": f(x, w, save_c=False, bf16_matmul=False,
                                   mask=None),
                    "masked": f(x, w, save_c=False, bf16_matmul=False,
                                mask=mask),
                    "train": f(x, w, save_c=True, bf16_matmul=False,
                               mask=None),
                    "train_masked": f(x, w, save_c=True, bf16_matmul=False,
                                      mask=mask)}

        args = tuple(map(jnp.asarray, (x, w, mask)))
        _FWD[H] = quick_jit(run, *args)(*args)
    return _FWD[H]


def test_widths_stream_one_and_several_tiles():
    """JAX's chunk rule gives H = 16 one tile and H = 24, 40 three and
    five, so the cases below hold #4's plain version to both."""
    tiles = [H // lstm_pallas._chunk_size(H, B, False) for H in WIDTHS]
    assert tiles == [1, 3, 5]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("H", WIDTHS)
def test_forward_matches_the_chunked_kernel(H, form):
    x, w, mask, _ = lstm_case(H)
    want = chunked_forms(H)[form]
    m = torch.tensor(mask) if "masked" in form else None
    save_c = form.startswith("train")
    got = lstm_seq.lstm_seq_reference(torch.tensor(x), torch.tensor(w), m,
                                      save_c=save_c)
    got = got if save_c else (got,)
    assert len(got) == len(want)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=0,
                                   atol=1e-5)
    if save_c:   # the training form the wrapper runs
        got = lstm_seq.lstm_seq_train(torch.tensor(x), torch.tensor(w), m)
        for g, wnt in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=0,
                                       atol=1e-5)


_BWD = {}


def bwd_seq_no_dw(H, monkeypatch):
    """JAX's _bwd_seq with its choice pinned to the form without a dW
    accumulator (S = 1, the whole batch): {masked: (dx, dW)}, one compile
    per width."""
    if H not in _BWD:
        monkeypatch.setattr(lstm_pallas, "_bwd_choice",
                            lambda T_, B_, *a, **kw: (1, B_, False, True))
        x, w, mask, g = lstm_case(H)
        h, c = lstm_seq.lstm_seq_reference(torch.tensor(x), torch.tensor(w),
                                           save_c=True)
        hm, cm = lstm_seq.lstm_seq_reference(
            torch.tensor(x), torch.tensor(w), torch.tensor(mask), save_c=True)

        def run(w, h, c, hm, cm, x, g, mask):
            return {False: lstm_pallas._bwd_seq(w, h, c, x, g),
                    True: lstm_pallas._bwd_seq(w, hm, cm, x, g, mask=mask)}

        args = tuple(jnp.asarray(np.asarray(a)) for a in (
            w, h, c, hm, cm, x, g, mask))
        _BWD[H] = quick_jit(run, *args)(*args)
    return _BWD[H]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("H", WIDTHS)
def test_backward_matches_bwd_seq_without_dw(H, masked, monkeypatch):
    """#5's wide form's plain version: dx_proj (the dgates the kernel
    emits, zero on masked steps) and dW_h against JAX's no-dW backward."""
    want_dx, want_dw = bwd_seq_no_dw(H, monkeypatch)[masked]
    x, w, mask, g = (torch.tensor(a) for a in lstm_case(H))
    m = mask if masked else None
    h, c = lstm_seq.lstm_seq_reference(x, w, m, save_c=True)
    dx, dw = lstm_seq.lstm_bwd_wide(w, h, c, x, g, m)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=0,
                               atol=1e-5)
    assert_leaves_close({"dw": dw.numpy()}, {"dw": np.asarray(want_dw)})
    if masked:
        assert float(dx[T - 1, 1:].abs().max()) == 0.0


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("H", WIDTHS)
def test_wide_dw_matches_the_plain_backward(H, masked):
    """dW_h as one matmul over the emitted dgates equals the plain
    backward's per-step sum."""
    x, w, mask, g = (torch.tensor(a) for a in lstm_case(H, seed=1))
    m = mask if masked else None
    h, c = lstm_seq.lstm_seq_reference(x, w, m, save_c=True)
    dx, dw = lstm_bidir.lstm_bwd_reference(w, h, c, x, g, m)
    assert_leaves_close({"dw": lstm_seq.wide_dw(h, dx).numpy()},
                        {"dw": dw.numpy()})


@pytest.mark.parametrize("H,wide", [(1024, False), (1025, True)])
def test_autograd_routes_by_width(H, wide, monkeypatch):
    """The training form's backward takes #5's wide form above H = 1024
    and #5 up to it, by width alone; either gives the plain gradients."""
    calls = []
    for mod, name in ((lstm_seq, "lstm_bwd_wide"), (lstm_bidir, "lstm_bwd")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **kw: (
            calls.append(_n) or _r(*a, **kw)))
    rng = np.random.default_rng(H)
    x = torch.tensor(rng.normal(size=(2, 1, 4 * H)).astype(np.float32),
                     requires_grad=True)
    w = torch.tensor((rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(
        np.float32), requires_grad=True)
    out = lstm_seq.lstm_seq(x, w)
    gx, gw = torch.autograd.grad(out.sum(), (x, w))
    assert calls == ["lstm_bwd_wide" if wide else "lstm_bwd"]
    assert lstm_seq.WIDE == 1024
    xs, ws = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    want = torch.autograd.grad(lstm_seq.lstm_seq_reference(xs, ws).sum(),
                               (xs, ws))
    assert_leaves_close({"dx": gx.numpy(), "dw": gw.numpy()},
                        {"dx": want[0].numpy(), "dw": want[1].numpy()})


@pytest.mark.parametrize("form", ["", "MASKED_", "TRAIN_"])
@pytest.mark.parametrize("H", [1024, 1025])
def test_launch_counters_route_by_width(H, form, monkeypatch):
    """A launch of width H counts on #3's counter of its form up to H =
    1024 and on #4's above."""
    names = [f"{pre}{form}LAUNCHES" for pre in ("", "WIDE_")]
    for name in names:
        monkeypatch.setattr(lstm_seq, name, 0)
    lstm_seq._count(H, form)
    assert [getattr(lstm_seq, n) for n in names] == (
        [0, 1] if H > lstm_seq.WIDE else [1, 0])


def test_plan_readers_parse_a_plan():
    """wide_fwd_plan's and wide_bwd_plan's readers of what
    e2e_lstm_wide_fwd_plan and e2e_lstm_wide_bwd_plan write."""
    assert lstm_seq.parse_wide_fwd_plan([1, 128, 10, 229376]) == {
        "route": "resident", "blocks": 128, "units": 10, "smem": 229376}
    assert lstm_seq.parse_wide_bwd_plan([1, 2, 64, 10, 229376, 66]) == {
        "route": "resident", "cluster": 2, "clusters": 64, "units": 10,
        "smem": 229376, "held": 66}
    assert lstm_seq.parse_wide_bwd_plan([0, 0, 0, 10, 0, 31])["route"] == (
        "streamed")


@pytest.mark.parametrize("H", [1025, 1088])
def test_lm_scan_wider_than_1024_matches_the_oracle(H):
    """core/rnn.lstm_scan at a width past #3's cap (its wrapper takes the
    plain version on the CPU; on the card #4) equals the step-by-step
    oracle, zeroed past each length."""
    rng = np.random.default_rng(H)
    params = {"kernel": torch.tensor((rng.normal(size=(6 + H, 4 * H))
                                      / np.sqrt(H)).astype(np.float32)),
              "bias": torch.tensor(rng.normal(size=4 * H).astype(
                  np.float32))}
    x = torch.tensor(rng.normal(size=(4, 2, 6)).astype(np.float32))
    lens = torch.tensor([4, 2])
    got = rnn.lstm_scan(params, x, lens)
    want = rnn.lstm_scan_reference(params, x, lens)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert float(got[2:, 1].abs().max()) == 0.0


def sp_setup():
    """The small recipe with an LM cell of 12 over decoders of 8 (so
    SimpleProjection), the LM task's config at that width, and the weights
    of both packages."""
    cfg = train_cfg()
    cfg = dataclasses.replace(cfg, decoders={
        t: dataclasses.replace(d, lm_hidden_size=12)
        for t, d in cfg.decoders.items()})
    lm_cfg = LMConfig(lm_batch_size=LM_B, out_prob=0.8, vocab_size=V,
                      lm_hidden_size=12, emb_size=8)
    jparams, named = init_both(cfg, 8)
    return cfg, lm_cfg, jparams, named


def test_lm_step_with_simple_projection_matches_jax():
    """The LM task on an LM cell wider than the decoder: the loss without
    and with dropout, and one LM step (loss, gradients read back from
    JAX's Adam state, params after) against JAX's jitted lm_step."""
    cfg, lm_cfg, jparams, named = sp_setup()
    assert "simple_proj" in jparams["decoder_char"]
    jstate = jstep.create_state(jparams, cfg, lm_cfg)
    _, jlm_step = jstep.make_train_step(cfg, lm_cfg)
    ids, lens, valid = lm_batch(3)
    key = jax.random.PRNGKey(5)
    jargs = (jstate, jnp.asarray(ids), jnp.asarray(lens), key,
             jnp.asarray(valid))

    def both(state, ids, lens, key, valid):
        loss = jrnn_lm.loss(state.params, lm_cfg, ids, lens, train=False,
                            valid=valid)
        return loss, jlm_step(state, ids, lens, key, valid)

    jloss, (jnew, jmetrics) = quick_jit(both, *jargs)(*jargs)
    state = step.create_state(checkpoint.params_from_named(named, cfg, "cpu"),
                              cfg, lm_cfg, device="cpu")
    got = rnn_lm.loss(state.params, lm_cfg, torch.tensor(ids),
                      torch.tensor(lens), train=False,
                      valid=torch.tensor(valid))
    np.testing.assert_allclose(float(got), float(jloss), rtol=1e-5)
    _, lm_step = step.make_train_step(cfg, lm_cfg, device="cpu")
    new, metrics = lm_step(state, ids, lens, None, valid,
                           noise=jax_mask(key, lm_cfg))
    np.testing.assert_allclose(float(metrics["lm_loss"]),
                               float(jmetrics["lm_loss"]), rtol=1e-5)
    head = "lm_opt_state/1/inner_state/0/mu/"
    jflat = jckpt.flatten_named(jnew)
    want_g = {k[len(head):]: np.asarray(v) / (1 - step.B1)
              for k, v in jflat.items() if k.startswith(head)}
    got_g = {k[len(head):]: v / (1 - step.B1)
             for k, v in step.state_to_named(new).items()
             if k.startswith(head)}
    assert "decoder_char/simple_proj/kernel" in want_g
    assert_leaves_close(got_g, want_g)
    got_p = step.state_to_named(new)
    for k, v in jflat.items():
        if k.startswith("params/"):
            np.testing.assert_allclose(got_p[k], np.asarray(v), rtol=0,
                                       atol=1e-6, err_msg=k)
    assert T_LM == 9
