"""Kernel #16 (`kernels/ctc_prefix.py`: the CTC prefix-score frame scan of
joint CTC/attention decoding) against its plain PyTorch version on the
card, and the CTC and hybrid families' card paths against the CPU
(marker `cuda`; skips without a GPU). Imports no JAX:
    pytest --noconftest -m cuda tests/test_torch_cuda_ctc.py

Scan cases: the serving shape (B=8, k=4, T=64, P=V=40), one utterance at
k=16, a pre-beam (P = k = 4 < V), T=61 (no multiple of 8), a row count
whose chains end inside a block, and states with NEG_INF slots and
`last` = -1 rows. Tolerance: 1e-5 of max(|value|, 1) (float32 lse chains
of up to 64 frames whose values reach hundreds of nats; expf / logf on the
card, the CPU's exp / log on the plain side), entries below NEG_INF / 2 on
one side below it on the other.
"""
import numpy as np
import pytest
import torch

from e2e_asr_tpu_torch.config import (BeamConfig, DecoderConfig,
                                      EncoderConfig, LMConfig,
                                      Seq2SeqConfig)
from e2e_asr_tpu_torch.core.checkpoint import named_from_params, to_device
from e2e_asr_tpu_torch.eval import beam_eval
from e2e_asr_tpu_torch.eval.ctc_prefix import NEG_INF, CTCPrefixScorer
from e2e_asr_tpu_torch.kernels import ctc_prefix
from e2e_asr_tpu_torch.train import step

torch.set_num_threads(1)
REL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def assert_scan_close(got, want, what=""):
    got, want = got.double().cpu(), want.double().cpu()
    assert got.shape == want.shape, what
    assert torch.equal(got < NEG_INF / 2, want < NEG_INF / 2), what
    fin = want >= NEG_INF / 2
    err = ((got[fin] - want[fin]).abs()
           / want[fin].abs().clamp_min(1.0)).max()
    assert float(err) <= REL, (what, float(err))


def scorer_inputs(dev, B, k, T, V, pre, seed):
    """Frame logits with ragged lengths, attention log-probs and a
    mid-decode scorer state (a dead slot at NEG_INF, `last` = -1 rows)."""
    rng = np.random.default_rng(seed)
    logits = torch.tensor(rng.normal(size=(B, T, V)).astype(np.float32) * 2,
                          device=dev)
    lens = torch.tensor(rng.integers(T // 2, T + 1, size=B), device=dev)
    lens[0] = T
    att = torch.tensor(rng.normal(size=(B, k, V)).astype(np.float32),
                       device=dev)
    scorer = CTCPrefixScorer(logits, lens, pre_beam=pre)
    state = scorer.init_state(k)
    state["rn"] = torch.tensor(rng.normal(size=(B, k, T)).astype(np.float32)
                               * 5 - 20, device=dev)
    state["rn"][:, -1] = NEG_INF
    state["last"] = torch.tensor(rng.integers(-1, V, size=(B, k)),
                                 dtype=torch.int32, device=dev)
    state["psi"] = torch.tensor(rng.normal(size=(B, k)).astype(np.float32)
                                - 10, device=dev)
    return scorer, state, att


# B, k, T, V, pre_beam
SCAN_CASES = [(8, 4, 64, 40, None), (1, 16, 64, 40, None),
              (8, 4, 64, 40, 4), (8, 4, 61, 40, None), (3, 1, 17, 40, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,k,T,V,pre", SCAN_CASES)
def test_prefix_scan_matches_plain(cuda, B, k, T, V, pre):
    """The kernel's psi, rn and rb on one joint step's scan inputs (the
    scorer's own gather, fresh and mid-decode) against the plain version
    on the same CUDA tensors."""
    scorer, state, att = scorer_inputs(cuda, B, k, T, V, pre, seed=B + k + T)
    for st in (scorer.init_state(k), state):
        _, args = scorer.scan_inputs(st, att)
        assert args[0].shape == (T, B * k, V if pre is None else
                                 min(V, max(pre, k)))
        before = ctc_prefix.LAUNCHES
        got = ctc_prefix.prefix_scan(*args)
        assert ctc_prefix.LAUNCHES == before + 1
        want = ctc_prefix.prefix_scan_reference(*args)
        torch.cuda.synchronize()
        for name, g, w in zip(("psi", "rn", "rb"), got, want):
            assert_scan_close(g, w, name)


@pytest.mark.cuda
def test_scorer_on_the_card_matches_the_cpu(cuda):
    """A step and a select of the scorer on CUDA tensors (kernel #16)
    against the same calls on CPU tensors (the plain version)."""
    runs = []
    for dev in (torch.device("cpu"), cuda):
        scorer, state, att = scorer_inputs(dev, 4, 3, 40, 30, 8, seed=5)
        delta, cand = scorer.step(state, att)
        parent = torch.tensor([[0, 0, 2]] * 4, device=dev)
        token = cand["cand"][torch.arange(4, device=dev)[:, None], parent,
                             torch.tensor([1, 0, 3], device=dev)]
        sel = scorer.select(cand, parent, token)
        runs.append([delta, cand["rn"], cand["psi"], sel["rn"], sel["rb"],
                     sel["psi"]])
    for name, g, w in zip(("delta", "cand rn", "cand psi", "rn", "rb",
                           "psi"), runs[1], runs[0]):
        assert_scan_close(g, w, name)


def hybrid_cfg(family="attention"):
    cfg = Seq2SeqConfig(tasks=["char"], num_layers={"char": 2},
                        max_output={"char": 10},
                        encoder=EncoderConfig(hidden_size=16, out_prob=0.8),
                        feat_length=8, model_family=family,
                        ctc_weight=0.3 if family == "attention" else 0.0)
    cfg.decoders["char"] = DecoderConfig(
        hidden_size_dec=16, emb_size=8, vocab_size=12, attention_vec_size=8,
        lm_hidden_size=16, samp_prob=0.0, out_prob_dec=0.8, max_output=10)
    return cfg


def small_batch():
    rng = np.random.default_rng(1)
    B, T, L = 5, 24, 7
    char_len = np.array([6, 4, 1, 6, 3])
    ids = np.zeros((B, L), np.int64)
    ids[:, 0] = 1
    for i, n in enumerate(char_len):
        ids[i, 1:n] = rng.integers(3, 12, size=n - 1)
        ids[i, n] = 2
    return {"logmel": rng.normal(size=(B, T, 8)).astype(np.float32),
            "logmel_len": np.array([24, 20, 9, 17, 24]), "char": ids,
            "char_len": char_len}


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["attention", "ctc"])
def test_step_on_the_card_matches_the_cpu(cuda, family):
    """The hybrid's (ctc_weight 0.3) and the CTC family's loss and
    gradients through asr_step's loss_and_grads on the card and on the
    CPU, with the same encoder noise: loss 1e-5 relative, gradients 1e-4
    of each leaf's largest value."""
    cfg = hybrid_cfg(family)
    gen = torch.Generator().manual_seed(0)
    params = step.init_params(gen, cfg, device="cpu")
    B, T = 5, 24
    noise = {"encoder": {1: torch.rand(T, B, 32, generator=gen) < 0.8,
                         2: torch.rand(T // 2, B, 32, generator=gen) < 0.8}}
    if family == "attention":
        from e2e_asr_tpu_torch.models import attn_decoder
        noise["char"] = attn_decoder.train_noise(gen, cfg.decoders["char"],
                                                 6, B, "cpu")
    runs = []
    for dev in ("cpu", cuda):
        asr_step, _ = step.make_train_step(cfg, LMConfig(), device=dev)
        state = step.create_state(params, cfg, LMConfig(), device=dev)
        loss, metrics, grads = asr_step.loss_and_grads(
            state.params, small_batch(), None, noise)
        runs.append((float(loss), named_from_params(grads)))
        assert "ctc" in metrics
    (loss_c, g_c), (loss_g, g_g) = runs
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    for name, want in g_c.items():
        scale = max(float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(g_g[name], want, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("pre", [0, 5])
def test_joint_beam_on_the_card_matches_the_cpu(cuda, pre):
    """make_beam_decoder's joint CTC/attention beams (beam 4, joint 0.4)
    of a hybrid with a peaked CTC head on the card (kernels #1, #11, #12,
    #14 and #16) and on the CPU: equal tokens and lengths, scores within
    1e-4; #16 launches once a step."""
    cfg = hybrid_cfg()
    params = step.init_params(torch.Generator().manual_seed(2), cfg,
                              device="cpu")
    params["ctc_head"]["kernel"] *= 10.0
    batch = small_batch()
    decode = beam_eval.make_beam_decoder(cfg, BeamConfig(
        beam_size=4, max_steps=10, joint_ctc=0.4, ctc_pre_beam=pre))
    before = ctc_prefix.LAUNCHES
    card = [x.cpu() for x in decode(to_device(params, cuda), batch)]
    launches = ctc_prefix.LAUNCHES - before
    cpu = decode(params, batch)
    assert 1 <= launches <= 10
    assert torch.equal(card[0], cpu[0]) and torch.equal(card[1], cpu[1])
    torch.testing.assert_close(card[2], cpu[2], rtol=0, atol=1e-4)
