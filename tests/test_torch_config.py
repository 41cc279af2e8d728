"""The port's own copies of what it needs from the JAX package's JAX-free
modules stay in step with them, and its entry points default to the card.

- config dataclasses: same field names, defaults and order as
  e2e_asr_tpu/config.py;
- vocabulary constants and text helpers: same values and results as
  e2e_asr_tpu/data/text.py;
- without a CUDA device, the entry points that default to the card raise
  unless the caller passes device="cpu".
"""
import dataclasses

import numpy as np
import pytest
import torch

import e2e_asr_tpu.config as jconfig
import e2e_asr_tpu.data.text as jtext
from e2e_asr_tpu_torch import config
from e2e_asr_tpu_torch.core import checkpoint
from e2e_asr_tpu_torch.data import text
from e2e_asr_tpu_torch.models import seq2seq
from e2e_asr_tpu_torch.train import step

torch.set_num_threads(1)
CLASSES = ("EncoderConfig", "DecoderConfig", "LMConfig", "Seq2SeqConfig",
           "BeamConfig")


def _fields(cls):
    out = []
    for f in dataclasses.fields(cls):
        default = (f.default_factory() if f.default_factory
                   is not dataclasses.MISSING else f.default)
        if dataclasses.is_dataclass(default):
            default = dataclasses.asdict(default)
        elif isinstance(default, dict):
            default = {k: dataclasses.asdict(v) if dataclasses.is_dataclass(v)
                       else v for k, v in default.items()}
        out.append((f.name, str(f.type), default))
    return out


def test_config_copy_matches_the_jax_package():
    for name in CLASSES:
        assert _fields(getattr(config, name)) == _fields(
            getattr(jconfig, name)), name
    assert (dataclasses.asdict(config.Seq2SeqConfig())
            == dataclasses.asdict(jconfig.Seq2SeqConfig()))


def test_text_copy_matches_the_jax_package():
    for name in ("PAD", "GO", "EOS", "START_VOCAB", "PAD_ID", "GO_ID",
                 "EOS_ID", "IGNORED_WORDS"):
        assert getattr(text, name) == getattr(jtext, name), name
    rev = text.START_VOCAB + ["<sp>", "a", "b", "!", "▁", "u", "h", "-"]
    for ids in ([3, 4, 5, 2, 4], [4, 7, 3, 4, 8, 9, 0, 5], [4, 10, 9, 3, 11]):
        sent = text.ids_to_sentence(ids, rev)
        assert sent == jtext.ids_to_sentence(ids, rev)
        assert text.get_relevant_words(sent) == jtext.get_relevant_words(sent)


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config.Seq2SeqConfig(
        num_layers={"char": 1}, encoder=config.EncoderConfig(hidden_size=4),
        decoders={"char": config.DecoderConfig(
            hidden_size_dec=4, emb_size=4, vocab_size=5,
            attention_vec_size=3, lm_hidden_size=4)}, feat_length=3)
    lm_cfg = config.LMConfig()
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        seq2seq.init(gen, cfg)
    params = seq2seq.init(gen, cfg, device="cpu")
    named = checkpoint.named_from_params(params)
    path = str(tmp_path / "p.npz")
    np.savez(path, **named)
    for call in (lambda: checkpoint.params_from_named(named, cfg),
                 lambda: checkpoint.load_npz(path, cfg),
                 lambda: step.create_state(params, cfg, lm_cfg),
                 lambda: step.make_train_step(cfg, lm_cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    back = checkpoint.load_npz(path, cfg, device="cpu")
    for k, v in checkpoint.flatten_named(back).items():
        np.testing.assert_array_equal(v.numpy(), named[k])
    state = step.create_state(params, cfg, lm_cfg, device="cpu")
    assert int(state.global_step) == 0
    step.make_train_step(cfg, lm_cfg, device="cpu")
