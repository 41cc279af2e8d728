"""Kernel #3 and the paths this slice adds, on the card (marker `cuda`;
they skip without a GPU): the unidirectional LSTM kernel in its three forms
against its plain version, its autograd through kernel #5, the LM step and
the char + phone ASR step on the card against the CPU, the greedy decode on
the card against the CPU, and the Trainer on the card over a tiny corpus.

These files import no JAX, so they also run where JAX is not installed:
    pytest --noconftest -m cuda tests/test_torch_cuda*.py

Tolerances: float32 sums in another order than the plain version's over
recurrences of up to 64 steps: 1e-4 absolute on values of order 1, 1e-4
relative to each gradient's largest value, 1e-5 relative on losses, 1e-6
on params after a step where the gradient is well above zero; greedy
tokens and the LM step's untied leaves exact.
"""
import os

import numpy as np
import pytest
import torch

from e2e_asr_tpu_torch import config
from e2e_asr_tpu_torch.core import checkpoint
from e2e_asr_tpu_torch.data import synth
from e2e_asr_tpu_torch.kernels import lstm_bidir, lstm_seq
from e2e_asr_tpu_torch.models import seq2seq
from e2e_asr_tpu_torch.train import step
from e2e_asr_tpu_torch.train.loop import Trainer

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


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(64, 5, 40), (16, 8, 256)])
def test_lstm_seq_forms_match_the_plain_version(cuda, T, B, H):
    rng = np.random.default_rng(0)
    x = _rand(rng, T, B, 4 * H, device=cuda)
    w = _rand(rng, H, 4 * H, scale=0.1, device=cuda)
    lens = rng.integers(1, T + 1, size=B)
    mask = torch.tensor((np.arange(T)[:, None] >= T - lens[None, :]).astype(
        np.float32)[:, :, None], device=cuda)
    counts = lambda: (lstm_seq.LAUNCHES, lstm_seq.MASKED_LAUNCHES,  # noqa
                      lstm_seq.TRAIN_LAUNCHES)
    before = counts()
    with torch.no_grad():
        got = [lstm_seq.lstm_seq(x, w), lstm_seq.lstm_seq(x, w, mask),
               *lstm_seq.lstm_seq_train(x, w, mask)]
    torch.cuda.synchronize()
    assert counts() == tuple(c + 1 for c in before)
    want = [lstm_seq.lstm_seq_reference(x, w),
            *lstm_seq.lstm_seq_reference(x, w, mask, save_c=True)]
    want.insert(1, want[1])
    for g, v in zip(got, want):
        torch.testing.assert_close(g, v, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_lstm_seq_gradients_run_kernel_5(cuda):
    rng = np.random.default_rng(1)
    T, B, H = 48, 6, 64
    x = _rand(rng, T, B, 4 * H, device=cuda)
    w = _rand(rng, H, 4 * H, scale=0.1, device=cuda)
    g = _rand(rng, T, B, H, device=cuda)
    leaves = [x.clone().requires_grad_(True), w.clone().requires_grad_(True)]
    counts = (lstm_seq.TRAIN_LAUNCHES, lstm_bidir.BWD_SINGLE_LAUNCHES)
    got = torch.autograd.grad(lstm_seq.lstm_seq(*leaves), leaves, g)
    torch.cuda.synchronize()
    assert (lstm_seq.TRAIN_LAUNCHES, lstm_bidir.BWD_SINGLE_LAUNCHES) == (
        counts[0] + 1, counts[1] + 1)
    ref = [t.detach().clone().requires_grad_(True) for t in (x, w)]
    want = torch.autograd.grad(lstm_seq.lstm_seq_reference(*ref), ref, g)
    for a, b in zip(got, want):
        scale = max(float(b.abs().max()), 1e-6)
        torch.testing.assert_close(a, b, atol=1e-4 * scale, rtol=0)


def _cfg() -> config.Seq2SeqConfig:
    def dec(vocab):
        return config.DecoderConfig(
            hidden_size_dec=32, emb_size=24, vocab_size=vocab,
            attention_vec_size=16, lm_hidden_size=32, samp_prob=0.0,
            out_prob_dec=0.8, max_output=10)

    return config.Seq2SeqConfig(
        tasks=["char", "phone"], num_layers={"char": 3, "phone": 2},
        max_output={"char": 10, "phone": 10},
        encoder=config.EncoderConfig(hidden_size=32, out_prob=0.8),
        decoders={"char": dec(13), "phone": dec(11)}, feat_length=10)


def _compare(got: dict, want: dict, rel: float):
    for name, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(got[name], w, atol=rel * scale, rtol=0,
                                   err_msg=name)


@pytest.mark.cuda
def test_lm_step_on_the_card_matches_the_cpu(cuda):
    """One LM step with the same dropout mask on both: the loss, every
    gradient, the params after it; the untied leaves keep their bits."""
    cfg = _cfg()
    lm_cfg = config.LMConfig(out_prob=0.9, lm_hidden_size=32)
    rng = np.random.default_rng(3)
    T, B = 21, 7
    lens = rng.integers(2, T, size=B)
    ids = np.zeros((T, B), np.int32)
    ids[0] = 1
    for b, n in enumerate(lens):
        ids[1:n, b] = rng.integers(3, 13, size=n - 1)
        ids[n, b] = 2
    valid = np.ones(B, np.float32)
    valid[-1] = 0
    gen = torch.Generator().manual_seed(3)
    params = seq2seq.init(gen, cfg, device="cpu")
    noise = torch.rand(T - 1, B, 32, generator=gen) < 0.9
    out = []
    for dev in ("cpu", cuda):
        _, lm_step = step.make_train_step(cfg, lm_cfg, device=dev)
        state = step.create_state(params, cfg, lm_cfg, device=dev)
        loss, grads = lm_step.loss_and_grads(state.params, ids, lens - 1,
                                             None, valid, noise)
        new_state, _ = lm_step(state, ids, lens - 1, None, valid, noise)
        out.append((float(loss), checkpoint.named_from_params(grads),
                    checkpoint.named_from_params(new_state.params)))
    (loss_c, g_c, p_c), (loss_g, g_g, p_g) = out
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    _compare(g_g, g_c, 1e-4)
    before = checkpoint.named_from_params(params)
    for name, w in g_c.items():
        big = np.abs(w) > max(1e-2 * float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(p_g[name][big], p_c[name][big], atol=1e-6,
                                   rtol=0, err_msg=name)
        if not np.abs(w).any():        # untied: the same bits as before
            assert np.array_equal(p_g[name], before[name]), name


@pytest.mark.cuda
def test_multitask_step_and_greedy_decode_on_the_card(cuda):
    """The char + phone ASR step on the card equals the CPU's (both
    decoders through the fused training kernels at their own shapes), and
    the greedy decode gives the CPU's tokens."""
    cfg, lm_cfg = _cfg(), config.LMConfig()
    rng = np.random.default_rng(4)
    B, T = 6, 40
    lens = rng.integers(10, T + 1, size=B)
    lens[0] = T
    batch = {"logmel": rng.normal(size=(B, T, 10)).astype(np.float32),
             "logmel_len": lens}
    for task, L, V in (("char", 8, 13), ("phone", 6, 11)):
        n = rng.integers(2, L, size=B)
        ids = np.zeros((B, L), np.int64)
        ids[:, 0] = 1
        for i, k in enumerate(n):
            ids[i, 1:k] = rng.integers(3, V, size=k - 1)
            ids[i, k] = 2
        batch[task], batch[f"{task}_len"] = ids, n
    gen = torch.Generator().manual_seed(4)
    params = seq2seq.init(gen, cfg, device="cpu")
    noise = {"encoder": {d: torch.rand(t, B, 64, generator=gen) < 0.8
                         for d, t in ((1, T), (2, T // 2), (3, T // 4))},
             "char": (None, None, (torch.rand(7, B, 32, generator=gen)
                                   < 0.8) / 0.8, ()),
             "phone": (None, None, (torch.rand(5, B, 32, generator=gen)
                                    < 0.8) / 0.8, ())}
    out = []
    for dev in ("cpu", cuda):
        asr_step, _ = step.make_train_step(cfg, lm_cfg, device=dev)
        state = step.create_state(params, cfg, lm_cfg, device=dev)
        loss, per_task, grads = asr_step.loss_and_grads(state.params, batch,
                                                        None, noise)
        tokens = seq2seq.apply_greedy(
            state.params, cfg, torch.tensor(batch["logmel"], device=dev),
            torch.tensor(lens, device=dev))
        out.append((float(loss), {k: float(v.detach()) for k, v in
                                  per_task.items()},
                    checkpoint.named_from_params(grads), tokens.cpu()))
    (loss_c, tasks_c, g_c, tok_c), (loss_g, tasks_g, g_g, tok_g) = out
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    for task in ("char", "phone"):
        assert abs(tasks_g[task] - tasks_c[task]) <= 1e-5 * tasks_c[task]
    _compare(g_g, g_c, 1e-4)
    assert torch.equal(tok_g, tok_c)


@pytest.mark.cuda
def test_trainer_on_the_card(cuda, tmp_path):
    root = str(tmp_path)
    sizes = synth.make_vocab_dir(os.path.join(root, "vocab"))
    data = os.path.join(root, "data")
    os.makedirs(os.path.join(data, "lm"))
    kw = dict(feat_length=10, char_vocab=12, min_tokens=3, max_tokens=6,
              frames_per_token=4)
    synth.write_speech_corpus(os.path.join(data, "train_1k.0.0001"), 12,
                              seed=0, **kw)
    synth.write_speech_corpus(os.path.join(data, "dev.0001"), 5, seed=1, **kw)
    synth.write_lm_corpus(os.path.join(data, "lm", "lm.0001"), 8, seed=2,
                          char_vocab=12, max_tokens=9)
    model = _cfg()
    model.decoders["char"].vocab_size = sizes["char"]
    model.decoders["phone"].vocab_size = sizes["phone"]
    tc = config.TrainConfig(
        batch_size=4, buck_batch_size=[4], num_buckets=1, max_epochs=1,
        min_steps=0, feat_length=10, data_dir=data,
        lm_data_dir=os.path.join(data, "lm"),
        vocab_dir=os.path.join(root, "vocab"),
        train_dir=os.path.join(root, "train"),
        best_model_dir=os.path.join(root, "best"), lm_prob=0.5,
        steps_per_checkpoint=3, compute_dtype="float32")
    cfg = config.ExperimentConfig(model=model, train=tc, lm=config.LMConfig(
        lm_batch_size=4, lm_hidden_size=32, vocab_size=sizes["char"]))
    launches = lstm_seq.TRAIN_LAUNCHES
    state = Trainer(cfg).train()
    assert int(state.global_step) == 6 and int(state.lm_global_step) > 0
    assert lstm_seq.TRAIN_LAUNCHES > launches
    named, _ = checkpoint.restore_latest(tc.train_dir)
    assert int(named["global_step"]) == 6
    resumed = Trainer(cfg)
    resumed.train_cfg = config.TrainConfig(**{**tc.__dict__,
                                              "max_epochs": 0})
    back = step.state_to_named(resumed.train())
    for k, v in named.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
