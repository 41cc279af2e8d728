"""Port parity for kernel #10 (the GRU decoder's whole training pass) and
the GRU decoder around it, on the CPU, where the wrapper runs its plain
version: the fused form (kernels/dec_train_gru.apply_train_fused, the
plain version `dec_train_gru_reference` with autograd) and the plain scan
(models/attn_decoder.apply_train with GRU cells) against JAX's
apply_train on its fused path, the TPU kernel
(ops/dec_train_gru_pallas.apply_train_fused) in interpret mode with its
custom VJP's Pallas backward: logits and gradients, with scheduled
sampling (0.5) and dropout (keep 0.7) on and JAX's own noise handed to
the port; the envelope of #10, and the greedy decode of the same GRU
decoder (kernel #11's GRU branch) against the decoder's own step. (The
whole model's scan against JAX's XLA scan is test_torch_gru_train_step.py's;
GRU decoding against JAX is test_torch_gru_decode.py's.)

Tolerances (float32, sums in other orders): forward values 1e-5 absolute;
gradients 1e-4 relative to each leaf's largest value.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_tpu.core import checkpoint as jckpt
from e2e_asr_tpu.models import attn_decoder as jdec
from e2e_asr_tpu.ops import dec_train_gru_pallas
from e2e_asr_tpu_torch.core import checkpoint
from e2e_asr_tpu_torch.kernels import dec_train_gru
from e2e_asr_tpu_torch.models import attn_decoder
from tests.test_torch_train_step import (B, L, V, assert_leaves_close,
                                         init_both, make_batch, quick_jit,
                                         train_cfg)

torch.set_num_threads(1)


def gru_cfg(cfg=None):
    """train_cfg() with GRU cells in the encoder and both decoders."""
    cfg = cfg or train_cfg()
    return dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, use_lstm=False),
        decoders={t: dataclasses.replace(d, use_lstm=False)
                  for t, d in cfg.decoders.items()})


@pytest.fixture(scope="module")
def decoder_case():
    """The char decoder's weights for both packages, encoder states, ids
    and the weights of the summed logits; JAX's apply_train on its fused
    path (ops/dec_train_gru_pallas.apply_train_fused, the TPU kernel in
    interpret mode, whose custom VJP is the Pallas backward; JAX's own
    tests hold it to the XLA scan): its logits, its gradients and its
    noise, drawn in the same jit."""
    cfg = gru_cfg()
    dcfg = cfg.decoders["char"]
    jparams, named = init_both(cfg, 3)
    rng = np.random.default_rng(2)
    enc = rng.normal(size=(B, 7, 16)).astype(np.float32)
    enc_lens = np.array([7, 4, 2], np.int32)
    ids = make_batch(4)["char"].T
    w = rng.normal(size=(L - 1, B, V)).astype(np.float32)
    key = jax.random.PRNGKey(11)

    def fused_and_noise(p, e):
        noise = jdec.train_noise(key, dcfg, L - 1, B)

        def jloss(p, e):
            out = dec_train_gru_pallas.apply_train_fused(
                p, dcfg, p["embedding"][jnp.asarray(ids)], e,
                jnp.asarray(enc_lens), *noise[:3], ())
            return jnp.sum(out * w), out

        return (jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
            p, e), noise)

    args = (jparams["decoder_char"], jnp.asarray(enc))
    ((_, logits), grads), noise = quick_jit(fused_and_noise, *args)(*args)
    assert float(noise[0].sum()) > 0           # sampling fires
    return (cfg, named, enc, enc_lens, ids, w, noise,
            (logits, jckpt.flatten_named(grads[0]), grads[1]))


@pytest.mark.parametrize("form", ["fused", "scan"])
def test_training_pass_matches_the_pallas_kernel(decoder_case, form):
    """#10's plain version (the fused form) and the GRU decoder's plain
    scan (attn_decoder.apply_train) equal the TPU kernel in interpret
    mode, logits and gradients, on the same noise."""
    cfg, named, enc, enc_lens, ids, w, noise, want = decoder_case
    dcfg = cfg.decoders["char"]
    flags, gumbel, lm_masks = (torch.tensor(np.asarray(a))
                               for a in noise[:3])
    params = checkpoint.params_from_named(named, cfg, "cpu")["decoder_char"]
    leaves = {k: v.requires_grad_(True)
              for k, v in checkpoint.flatten_named(params).items()}
    e = torch.tensor(enc, requires_grad=True)
    lens = torch.tensor(enc_lens)
    before = dec_train_gru.FWD_LAUNCHES + dec_train_gru.BWD_LAUNCHES
    if form == "scan":
        logits = attn_decoder.apply_train(params, dcfg, torch.tensor(ids), e,
                                          lens, noise=(flags, gumbel,
                                                       lm_masks, ()))
    else:
        emb_in = params["embedding"][torch.tensor(ids).long()]
        logits = dec_train_gru.apply_train_fused(params, dcfg, emb_in, e,
                                                 lens, flags, gumbel,
                                                 lm_masks)
    torch.sum(logits * torch.tensor(w)).backward()
    assert dec_train_gru.FWD_LAUNCHES + dec_train_gru.BWD_LAUNCHES == before
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want[0]),
                               rtol=0, atol=1e-5)
    assert_leaves_close({k: v.grad.numpy() for k, v in leaves.items()},
                        want[1])
    assert_leaves_close({"enc": e.grad.numpy()}, {"enc": want[2]})


def test_envelope_and_gru_decode_raise(decoder_case):
    """#10 takes one decoder layer without SimpleProjection (the plain scan
    takes the rest). A GRU decoder decodes: the greedy decode (kernel B's
    GRU branch, the attention and kernel C, their plain versions here)
    gives the argmax ids of the decoder's own step, <pad> after <eos>.
    (Decoding GRU decoders raised before kernel #11's GRU branch was
    ported; the test keeps its name.)"""
    cfg, named, enc, enc_lens, ids, _, _, _ = decoder_case
    dcfg = cfg.decoders["char"]
    params = checkpoint.params_from_named(named, cfg, "cpu")["decoder_char"]
    emb_in = params["embedding"][torch.tensor(ids).long()]
    e, lens = torch.tensor(enc), torch.tensor(enc_lens)
    for bad in (dict(params, dec_cells=params["dec_cells"] * 2),
                dict(params, simple_proj={})):
        with pytest.raises(NotImplementedError, match="deeper decoders"):
            dec_train_gru.apply_train_fused(bad, dcfg, emb_in, e, lens, None,
                                            None, None)
    deep = dataclasses.replace(dcfg, num_layers_dec=2, lm_hidden_size=6)
    p2 = attn_decoder.init(torch.Generator().manual_seed(1), deep, 16,
                           device="cpu")
    assert {"simple_proj", "dec_cells"} <= set(p2)
    out = attn_decoder.apply_train(p2, deep, torch.tensor(ids), e, lens,
                                   gen=torch.Generator().manual_seed(2))
    assert out.shape == (L - 1, B, V) and bool(torch.isfinite(out).all())
    out = params["output_proj"]
    out["bias"] = out["bias"] + 0.8 * (torch.arange(V) == 2)  # one finishes
    go = torch.ones(B).long()
    got = attn_decoder.apply_infer_early(params, dcfg, go, e, lens,
                                         max_output=6)
    ctx = attn_decoder.make_attn_context(params, e, lens)
    state, x = attn_decoder.zero_state(dcfg, B, ctx), params["embedding"][go]
    done = torch.zeros(B, dtype=torch.bool)
    for t in range(got.shape[0]):
        state, logits = attn_decoder.step(params, dcfg, ctx, state, x)
        ids = torch.where(done, 0, logits.argmax(-1))
        assert torch.equal(got[t], ids), t
        done, x = done | (ids == 2), params["embedding"][ids]
    assert bool(done.any()) and not bool(done.all()) and got.shape[1] == B
