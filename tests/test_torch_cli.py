"""The port's command line against the JAX package's on the CPU:

- the parser: every flag with the same option strings, destination,
  default, type, choices and action;
- `process_args`, `get_run_dir_name` and the parameters.txt text
  (`config_to_text`) equal to JAX's for a few argument lists, and
  `config_from_text` / `clone` round trips;
- `main` with `-platform cpu` at tiny widths on a synthetic corpus: it
  trains (writing JAX's parameters.txt bytes), evaluates `-dev` greedily,
  and with `-beam_size 2 -buck_batch_sizes 1` through kernel #15's route
  (its plain version on the CPU), and `-test`;
- what the port does not honour raises, bf16 by default included.
No test here builds a JAX Trainer (it changes JAX's PRNG process-wide).
"""
import argparse
import os

import pytest
import torch

from e2e_asr_tpu import config as jconfig
from e2e_asr_tpu.cli import main as jmain
from e2e_asr_tpu_torch import config
from e2e_asr_tpu_torch.cli import main
from e2e_asr_tpu_torch.data import synth
from e2e_asr_tpu_torch.kernels import beam_mega

torch.set_num_threads(1)


def _actions(module):
    parser = argparse.ArgumentParser()
    module.add_parse_options(parser)
    return {a.dest: (a.option_strings, a.default, a.type, a.choices,
                     type(a).__name__, a.const)
            for a in parser._actions}


def test_parser_matches_jax():
    port, jax_ = _actions(config), _actions(jconfig)
    assert port == jax_
    assert len(port) > 100


ARGVS = {
    "defaults": [],
    "phone_task": ["-tasks", "p", "-nlp", "2"],
    "batch1_lm": ["-buck_batch_sizes", "1", "-lm_prob", "0.5"],
    "deep_decoder": ["-num_layers_dec", "2", "-beam_size", "4", "-dev",
                     "-word_ins_penalty", "0.3", "-avg"],
}


@pytest.mark.parametrize("name", list(ARGVS))
def test_process_args_matches_jax(name):
    argv = ARGVS[name] + ["-compute_dtype", "float32"]
    sizes = {"char": 37, "phone": 46}
    got, want = [vars(_parser(m).parse_args(argv)) for m in (config, jconfig)]
    assert got == want
    opts = dict(got, tasks=config.parse_tasks(got["tasks"]))
    assert config.get_run_dir_name(opts) == jconfig.get_run_dir_name(opts)
    cfg = config.process_args(got, sizes)
    text = config.config_to_text(cfg)
    assert text == jconfig.config_to_text(jconfig.process_args(want, sizes))
    back = config.config_from_text(text)
    assert back == cfg and config.clone(cfg) == cfg
    assert config.config_to_text(jconfig.config_from_text(text)) == text


def _parser(module):
    parser = argparse.ArgumentParser()
    module.add_parse_options(parser)
    return parser


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_cli"))
    data = os.path.join(root, "data")
    os.makedirs(data)
    synth.make_vocab_dir(os.path.join(root, "vocab"))
    kw = dict(feat_length=8, char_vocab=20, min_tokens=3, max_tokens=5,
              frames_per_token=4)
    synth.write_speech_corpus(os.path.join(data, "train_1k.0.0001"), 8, **kw)
    synth.write_speech_corpus(os.path.join(data, "dev.0001"), 3, seed=2,
                              **kw)
    synth.write_speech_corpus(os.path.join(data, "eval2000.0001"), 3, seed=3,
                              **kw)
    return root


def _args(root, *extra, batch="4"):
    return ["-data_dir", os.path.join(root, "data"),
            "-vocab_dir", os.path.join(root, "vocab"),
            "-tb_dir", os.path.join(root, "models"),
            "-hsize", "8", "-hsize_dec", "8", "-emb_size", "8",
            "-attn_vec_size", "4", "-lm_hsize", "8", "-nlc", "2",
            "-feat_len", "8", "-max_out_char", "8",
            "-buck_batch_sizes", batch, "-steps_per_checkpoint", "2",
            "-max_epochs", "0", "-compute_dtype", "float32", "-run_id", "9",
            "-platform", "cpu", *extra]


def test_main_trains_and_evaluates_on_the_cpu(workspace, monkeypatch,
                                              capsys):
    root = workspace
    want = jmain.parse_options(_args(root))
    with open(os.path.join(want.train.train_dir, "parameters.txt"),
              "rb") as f:
        jax_params_txt = f.read()
    main.main(_args(root))
    train_dir = want.train.train_dir
    with open(os.path.join(train_dir, "parameters.txt"), "rb") as f:
        assert f.read() == jax_params_txt
    assert sorted(os.listdir(train_dir)) == [
        "asr.ckpt-2.npz", "asr_err.txt", "checkpoint", "parameters.txt",
        "summary"]
    capsys.readouterr()

    best = want.train.best_model_dir
    main.main(_args(root, "-dev"))
    out = capsys.readouterr().out
    assert f"Using the model from: {train_dir}/asr.ckpt-2.npz" in out
    assert os.path.isfile(os.path.join(best, "decoded_asr.txt"))

    calls = []
    ref = beam_mega.beam_decode_mega_reference
    monkeypatch.setattr(beam_mega, "beam_decode_mega_reference",
                        lambda *a, **kw: calls.append(1) or ref(*a, **kw))
    main.main(_args(root, "-dev", "-beam_size", "2", batch="1"))
    out = capsys.readouterr().out
    assert len(calls) == 3          # one search per dev utterance
    assert "Score:" in out and "Insertion:" in out
    with open(os.path.join(best, "raw_2.txt")) as f:
        assert len(f.read().splitlines()) == 3

    main.main(_args(root, "-test", "-beam_size", "2", "-run_id", "8"))
    out = capsys.readouterr().out
    assert "Total test files: 1" in out
    assert "Using the model from: None" in out      # nothing trained


def test_what_the_port_lacks_raises(workspace, monkeypatch):
    root = workspace
    argv = _args(root)
    with pytest.raises(NotImplementedError, match="-compute_dtype float32"):
        main.main(argv[:argv.index("-compute_dtype")]
                  + argv[argv.index("-run_id"):])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="-platform cpu"):
        main.main(_args(root, "-platform", ""))
    with pytest.raises(ValueError, match="platform"):
        main.main(_args(root, "-platform", "tpu"))
    for extra in (["-dist_coordinator", "localhost:1"], ["-ssl"],
                  ["-ema_decay", "0.9"], ["-lora_rank", "2"],
                  ["-dev", "-eval_ema"], ["-dev", "-quantize", "int8"],
                  ["-dev", "-eval_avg_ckpts", "3"], ["-dev", "-data_axis", "2"],
                  ["-dev", "-lm_path", "lm.npz"],
                  ["-dev", "-boost_phrases", "p.txt", "-boost_weight", "1"],
                  ["-dev", "-beam_size", "2", "-lm_weight", "0.1"],
                  ["-dev", "-beam_size", "2", "-ctc_rescore", "0.3"],
                  ["-dev", "-nbest", "2"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            main.main(_args(root, *extra, "-run_id", "7"))
