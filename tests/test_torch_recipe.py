"""Port parity for the rest of the recipe on the CPU: the synthetic corpus
writer, the speech and LM datasets, the WER, the greedy evaluator on
checkpoints written by either package, and the port's Trainer (trains with
the phone multitask and the LM task, evaluates, saves and resumes).

Exact comparisons throughout: corpus bytes, batches, WER counts, greedy
token ids and the evaluators' output files must be equal.
"""
import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_tpu.config import LMConfig as JLMConfig
from e2e_asr_tpu.core import checkpoint as jckpt
from e2e_asr_tpu.data import synth as jsynth
from e2e_asr_tpu.data.lm import LMDataset as JLMDataset
from e2e_asr_tpu.data.speech import SpeechDataset as JSpeechDataset
from e2e_asr_tpu.eval import greedy as jgreedy
from e2e_asr_tpu.eval import score as jscore
from e2e_asr_tpu.train import step as jstep
from e2e_asr_tpu_torch import config
from e2e_asr_tpu_torch.core import checkpoint
from e2e_asr_tpu_torch.data import synth, text
from e2e_asr_tpu_torch.data.lm import LMDataset
from e2e_asr_tpu_torch.data.speech import SpeechDataset
from e2e_asr_tpu_torch.eval import greedy, score
from e2e_asr_tpu_torch.models import seq2seq
from e2e_asr_tpu_torch.train import step
from e2e_asr_tpu_torch.train.loop import Trainer
from tests.test_e2e import small_model_cfg
from tests.test_torch_train_step import init_both

torch.set_num_threads(1)
FEAT = 8
SYNTH = dict(feat_length=FEAT, char_vocab=12, min_tokens=3, max_tokens=6,
             frames_per_token=4)


def write_corpus(root, pkg) -> dict:
    sizes = pkg.make_vocab_dir(os.path.join(root, "vocab"))
    data = os.path.join(root, "data")
    os.makedirs(os.path.join(data, "lm"))
    pkg.write_speech_corpus(os.path.join(data, "train_1k.0.0001"), 10,
                            seed=0, **SYNTH)
    pkg.write_speech_corpus(os.path.join(data, "dev.0001"), 6, seed=1,
                            **SYNTH)
    pkg.write_lm_corpus(os.path.join(data, "lm", "lm.0001"), 9, seed=2,
                        char_vocab=12, max_tokens=9)
    return sizes


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_recipe"))
    sizes = write_corpus(root, synth)
    _, rev_vocab = text.initialize_vocabulary(
        os.path.join(root, "vocab", "char.vocab"))
    return root, sizes, rev_vocab


def test_synth_corpus_and_datasets_equal_jax(corpus, tmp_path):
    root, sizes, _ = corpus
    assert write_corpus(str(tmp_path), jsynth) == sizes
    names = ["vocab/char.vocab", "vocab/phone.vocab", "data/dev.0001",
             "data/train_1k.0.0001", "data/lm/lm.0001"]
    for name in names:
        assert filecmp.cmp(os.path.join(root, name),
                           os.path.join(tmp_path, name), shallow=False), name
    data = os.path.join(root, "data")
    train = [os.path.join(data, "train_1k.0.0001")]
    pairs = [(SpeechDataset(train, 4, FEAT, is_training=True,
                            tasks=("char", "phone")),
              JSpeechDataset(train, 4, FEAT, is_training=True,
                             tasks=("char", "phone"))),
             (SpeechDataset([os.path.join(data, "dev.0001")], 4, FEAT,
                            is_training=False),
              JSpeechDataset([os.path.join(data, "dev.0001")], 4, FEAT,
                             is_training=False)),
             (LMDataset([os.path.join(data, "lm", "lm.0001")], 4),
              JLMDataset([os.path.join(data, "lm", "lm.0001")], 4))]
    for port_ds, jax_ds in pairs:
        for _ in range(2):                    # two reshuffled epochs
            got, want = list(port_ds.epoch()), list(jax_ds.epoch())
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_wer_matches_jax():
    rng = np.random.default_rng(0)
    words = ["a", "b", "c", "uh", "d-", "ee"]
    port, jax_acc = score.WerAccumulator(), jscore.WerAccumulator()
    for _ in range(40):
        hyp = [str(w) for w in rng.choice(words, size=rng.integers(0, 7))]
        ref = [str(w) for w in rng.choice(words, size=rng.integers(0, 7))]
        assert dataclasses.asdict(score.edit_distance(hyp, ref)) == (
            dataclasses.asdict(jscore.edit_distance(hyp, ref)))
        unit = "char" if rng.random() < 0.3 else "word"
        score.accumulate(port, hyp, ref, unit)
        jscore.accumulate(jax_acc, hyp, ref, unit)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_acc)
    assert port.score == jax_acc.score > 0


def test_greedy_decode_of_either_packages_checkpoint(corpus, tmp_path):
    """A JAX-written checkpoint decodes in the port as in JAX, and the
    port's checkpoint of other weights decodes in JAX as in the port: the
    same token ids, WER and output files."""
    root, sizes, rev_vocab = corpus
    cfg = small_model_cfg(sizes["char"], feat=FEAT)
    lm_cfg = JLMConfig(vocab_size=sizes["char"])
    jparams, _ = init_both(cfg, 0)
    out = dict(jparams["decoder_char"]["output_proj"])
    out["bias"] = out["bias"].at[text.EOS_ID].add(0.3)   # rows finish
    jparams["decoder_char"]["output_proj"] = out
    jstate = jstep.create_state(jparams, cfg, lm_cfg)
    jpath = jckpt.save(str(tmp_path / "jax"), "asr.ckpt", 3, jstate)
    dev = SpeechDataset([os.path.join(root, "data", "dev.0001")], 4, FEAT,
                        is_training=False)
    jev = jgreedy.GreedyEvaluator(cfg, rev_vocab, str(tmp_path / "jout"))
    pev = greedy.GreedyEvaluator(cfg, rev_vocab, str(tmp_path / "pout"),
                                 device="cpu")
    template = step.create_state(seq2seq.init(torch.Generator(), cfg,
                                              device="cpu"),
                                 cfg, lm_cfg, device="cpu")

    def same(jax_params, port_params):
        finished = 0
        for batch in dev.epoch():
            want = np.asarray(jev._decode(params=jax_params,
                                          feats=batch["logmel"],
                                          feat_lens=batch["logmel_len"]))
            got = seq2seq.apply_greedy(port_params, cfg,
                                       torch.tensor(batch["logmel"]),
                                       torch.tensor(batch["logmel_len"]))
            np.testing.assert_array_equal(got.numpy(), want)
            finished += int(((want == text.EOS_ID).any(1)
                             & batch["valid"]).sum())
        assert jev(jax_params, dev.epoch()) == pev(port_params, dev.epoch())
        for kind in ("gold", "raw", "decoded"):
            name = f"{kind}_asr.txt"
            assert filecmp.cmp(tmp_path / "jout" / name,
                               tmp_path / "pout" / name, shallow=False)
        return finished

    named, _ = checkpoint.restore_latest(os.path.dirname(jpath))
    state = step.state_from_named(named, template)
    assert same(jparams, state.params) > 0

    params = {**state.params, "decoder_char": {
        **state.params["decoder_char"],
        "embedding": state.params["decoder_char"]["embedding"] * 1.5}}
    ppath = checkpoint.save(str(tmp_path / "port"), "asr.ckpt", 4,
                            step.state_to_named(state._replace(
                                params=params)))
    head = "params/"
    back = jckpt.unflatten_named(jparams, {
        k[len(head):]: v for k, v in jckpt.load_named(ppath).items()
        if k.startswith(head)})
    same(jax.tree_util.tree_map(jnp.asarray, back), params)


def recipe_cfg(root, sizes, **train) -> config.ExperimentConfig:
    def dec(vocab):
        return config.DecoderConfig(
            hidden_size_dec=8, emb_size=8, vocab_size=vocab,
            attention_vec_size=6, lm_hidden_size=8, max_output=10)

    model = config.Seq2SeqConfig(
        tasks=["char", "phone"], num_layers={"char": 2, "phone": 1},
        max_output={"char": 10, "phone": 10},
        encoder=config.EncoderConfig(hidden_size=8),
        decoders={"char": dec(sizes["char"]), "phone": dec(sizes["phone"])},
        feat_length=FEAT)
    data = os.path.join(root, "data")
    tc = config.TrainConfig(**{**dict(
        batch_size=4, buck_batch_size=[4], num_buckets=1, max_epochs=1,
        min_steps=0, feat_length=FEAT, data_dir=data,
        lm_data_dir=os.path.join(data, "lm"),
        vocab_dir=os.path.join(root, "vocab"),
        train_dir=os.path.join(root, "train"),
        best_model_dir=os.path.join(root, "best"), lm_prob=0.5,
        steps_per_checkpoint=2, compute_dtype="float32"), **train})
    return config.ExperimentConfig(model=model, train=tc, lm=config.LMConfig(
        lm_batch_size=4, vocab_size=sizes["char"], lm_hidden_size=8,
        emb_size=8))


def test_trainer_trains_evaluates_saves_and_resumes(corpus, capsys):
    """Two epochs of two ASR steps with the LM coin: two checkpoint
    cadences, each with a dev greedy eval and a save; a second Trainer on
    the same directory resumes the saved step's state."""
    root, sizes, _ = corpus
    cfg = recipe_cfg(root, sizes)
    final = Trainer(cfg, device="cpu").train()
    train_dir = cfg.train.train_dir
    assert int(final.global_step) == 4 and int(final.epoch) == 2
    assert int(final.lm_global_step) > 0
    with open(os.path.join(train_dir, "asr_err.txt")) as f:
        assert len(f.read().split()) == 2
    named, meta = checkpoint.restore_latest(train_dir)
    assert int(named["global_step"]) == 4 and "best" in meta
    assert sorted(os.listdir(train_dir)) == [
        "asr.ckpt-2.npz", "asr.ckpt-4.npz", "asr_err.txt", "checkpoint",
        "summary"]
    for kind in ("gold", "raw", "decoded"):
        assert os.path.isfile(os.path.join(cfg.train.best_model_dir,
                                           f"{kind}_asr.txt"))
    out = capsys.readouterr().out
    assert out.count("ASR error:") == 2 and "LM steps:" in out

    resumed = Trainer(cfg, device="cpu")
    resumed.train_cfg = dataclasses.replace(cfg.train, max_epochs=0)
    state = resumed.train()                 # resumes, then nothing to do
    assert "Resumed from step 4" in capsys.readouterr().out
    back = step.state_to_named(state)
    assert back.keys() == named.keys()
    for k, v in named.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_trainer_options_the_port_lacks_raise(corpus):
    root, sizes, _ = corpus
    for kw in (dict(ema_decay=0.9), dict(mwer=True), dict(fsdp=True),
               dict(pretrain_lm_path="x"), dict(compute_dtype="bfloat16")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Trainer(recipe_cfg(root, sizes, **kw), device="cpu")
    with pytest.raises(ValueError, match="train_dir"):
        Trainer(recipe_cfg(root, sizes, train_dir=""), device="cpu")
