"""Port parity for the modules of the training slice that hold a kernel,
on the CPU, where each wrapper runs its plain version:
- kernel A's training form and backward (kernels/lstm_bidir.py) against
  the JAX package's bidirectional layer (jax.vjp of core/rnn.rnn_layer),
  its residual-saving Pallas forward (interpret mode) and its
  single-direction backward with a carry mask (`_bwd_seq_xla`);
- the decoder's training pass, as the plain scan
  (models/attn_decoder.apply_train) and in the fused kernels' form
  (kernels/dec_train.apply_train_fused), against JAX's apply_train with its
  own noise (scheduled sampling and dropout on): logits and jax.grad.

Tolerances (float32, sums in other orders): forward values 1e-5 absolute;
gradients 1e-4 relative to each leaf's largest value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_tpu.core import checkpoint as jckpt
from e2e_asr_tpu.core import rnn as jrnn
from e2e_asr_tpu.models import attn_decoder as jdec
from e2e_asr_tpu.models import seq2seq as jseq2seq
from e2e_asr_tpu.ops import lstm_pallas
from e2e_asr_tpu_torch.core import checkpoint, rnn
from e2e_asr_tpu_torch.kernels import dec_train, lstm_bidir
from e2e_asr_tpu_torch.models import attn_decoder
from tests.test_torch_lstm_bidir import _kernel_inputs, _layer_inputs
from tests.test_torch_train_step import (B, L, V, assert_leaves_close,
                                         make_batch, train_cfg)

torch.set_num_threads(1)


@pytest.mark.parametrize("padded", [False, True])
def test_layer_backward_matches_jax_vjp(padded):
    """rnn_layer's gradients (through _LSTMBidir, whose CPU backward is
    lstm_bwd_reference) equal jax.vjp of JAX's rnn_layer."""
    params, x, lens = _layer_inputs(4)
    if not padded:
        lens[:] = x.shape[0]
    ct = np.random.default_rng(5).normal(
        size=(x.shape[0], x.shape[1], 16)).astype(np.float32)
    @jax.jit
    def jax_vjp(p, xx, c):
        out, vjp = jax.vjp(lambda p, xx: jrnn.rnn_layer(p, xx,
                                                        jnp.asarray(lens)),
                           p, xx)
        return out, *vjp(c)

    out, jgp, jgx = jax_vjp(jax.tree_util.tree_map(jnp.asarray, params),
                            jnp.asarray(x), jnp.asarray(ct))
    tp = jax.tree_util.tree_map(lambda a: torch.tensor(a, requires_grad=True),
                                params)
    tx = torch.tensor(x, requires_grad=True)
    got = rnn.rnn_layer(tp, tx, torch.tensor(lens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=1e-5, rtol=0)
    before = lstm_bidir.TRAIN_LAUNCHES + lstm_bidir.BWD_LAUNCHES
    got.backward(torch.tensor(ct))
    assert lstm_bidir.TRAIN_LAUNCHES + lstm_bidir.BWD_LAUNCHES == before
    assert_leaves_close(
        {f"{d}/{k}": tp[d][k].grad.numpy() for d in tp for k in tp[d]},
        {f"{d}/{k}": np.asarray(jgp[d][k]) for d in jgp for k in jgp[d]})
    assert_leaves_close({"x": tx.grad.numpy()}, {"x": jgx})


def test_training_forward_saves_c_as_pallas():
    """The training form's h and c equal the residuals of the TPU kernel's
    residual-saving forward (interpret mode) on ragged lengths."""
    args = _kernel_inputs(6)
    (h_fw, h_bw), res = lstm_pallas._lstm_seq_bidir_fwd(
        *map(jnp.asarray, args), None, False, 1.0)
    got = lstm_bidir.lstm_seq_bidir_train(*map(torch.tensor, args))
    for g, w in zip(got, (h_fw, h_bw, res[8], res[9])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


def test_single_direction_backward_with_mask():
    """lstm_bwd (#5's function) with a carry mask equals the reference's
    _bwd_seq_xla; lstm_bidir_bwd (#2's) equals it twice; on the CPU the
    wrappers run the plain version and count no launch."""
    xf, xb, wf, wb, mask = map(torch.tensor, _kernel_inputs(7))
    h_fw, h_bw, c_fw, c_bw = lstm_bidir.lstm_seq_bidir_train(xf, xb, wf, wb,
                                                             mask)
    rng = np.random.default_rng(8)
    g_fw, g_bw = (torch.tensor(rng.normal(size=h_fw.shape).astype(np.float32))
                  for _ in range(2))
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    want_bw = lstm_pallas._bwd_seq_xla(j(wb), j(h_bw), j(c_bw), j(xb),
                                       j(g_bw), mask=j(mask))
    want_fw = lstm_pallas._bwd_seq_xla(j(wf), j(h_fw), j(c_fw), j(xf),
                                       j(g_fw))
    counts = (lstm_bidir.BWD_LAUNCHES, lstm_bidir.BWD_SINGLE_LAUNCHES)
    got_bw = lstm_bidir.lstm_bwd(wb, h_bw, c_bw, xb, g_bw, mask)
    got = lstm_bidir.lstm_bidir_bwd(wf, wb, h_fw, c_fw, xf, g_fw, h_bw, c_bw,
                                    xb, g_bw, mask)
    assert (lstm_bidir.BWD_LAUNCHES,
            lstm_bidir.BWD_SINGLE_LAUNCHES) == counts
    for g, w in zip((*got_bw, *got), (*want_bw, *want_fw, *want_bw)):
        assert_leaves_close({"x": g.numpy()}, {"x": np.asarray(w)})


@pytest.fixture(scope="module")
def decoder_case():
    """JAX's decoder training pass: logits and jax.grad of their weighted
    sum w.r.t. the decoder weights and the encoder states."""
    cfg = train_cfg()
    dcfg = cfg.decoders["char"]
    jparams = jax.jit(lambda k: jseq2seq.init(k, cfg))(jax.random.PRNGKey(3))
    rng = np.random.default_rng(2)
    enc = rng.normal(size=(B, 7, 16)).astype(np.float32)
    enc_lens = np.array([7, 4, 2], np.int32)
    ids = make_batch(4)["char"].T
    w = rng.normal(size=(L - 1, B, V)).astype(np.float32)
    key = jax.random.PRNGKey(11)

    def jloss(p, e):
        out = jdec.apply_train(p, dcfg, jnp.asarray(ids), e,
                               jnp.asarray(enc_lens), rng=key)
        return jnp.sum(out * w), out

    (_, logits), (gp, ge) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jparams["decoder_char"],
                                              jnp.asarray(enc))
    noise = jdec.train_noise(key, dcfg, L - 1, B)
    assert float(noise[0].sum()) > 0           # sampling fires
    return (cfg, jckpt.flatten_named(jparams), enc, enc_lens, ids, w, noise,
            logits, jckpt.flatten_named(gp), ge)


@pytest.mark.parametrize("form", ["scan", "fused"])
def test_decoder_train_pass_matches_jax(decoder_case, form):
    (cfg, named, enc, enc_lens, ids, w, noise, want, want_gp,
     want_ge) = decoder_case
    dcfg = cfg.decoders["char"]
    flags, gumbel, lm_masks = (torch.tensor(np.asarray(a))
                               for a in noise[:3])
    params = checkpoint.params_from_named(named, cfg, "cpu")["decoder_char"]
    leaves = {k: v.requires_grad_(True)
              for k, v in checkpoint.flatten_named(params).items()}
    e = torch.tensor(enc, requires_grad=True)
    lens = torch.tensor(enc_lens)
    if form == "scan":
        logits = attn_decoder.apply_train(params, dcfg, torch.tensor(ids), e,
                                          lens, noise=(flags, gumbel,
                                                       lm_masks, ()))
    else:
        before = dec_train.FWD_LAUNCHES + dec_train.BWD_LAUNCHES
        emb_in = params["embedding"][torch.tensor(ids).long()]
        logits = dec_train.apply_train_fused(params, dcfg, emb_in, e, lens,
                                             flags, gumbel, lm_masks)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    torch.sum(logits * torch.tensor(w)).backward()
    if form == "fused":
        assert dec_train.FWD_LAUNCHES + dec_train.BWD_LAUNCHES == before
    assert_leaves_close({k: v.grad.numpy() for k, v in leaves.items()},
                        want_gp)
    assert_leaves_close({"enc": e.grad.numpy()}, {"enc": want_ge})
