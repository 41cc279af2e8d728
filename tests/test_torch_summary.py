"""The port's Trainer writes TensorBoard summaries as the JAX Trainer does
(core/summary.py, a copy of the JAX package's writer):
train_dir/summary holds one tfevents file of TFRecords, a file-version
event and then scalar events, and the (tag, step) sequence of a short run
equals the JAX Trainer's: two epochs of two ASR steps with the LM coin on
tests/test_torch_recipe.py's corpus and configuration ("ASR Perplexity",
"Learning rate", "Frames per sec" and "ASR Error" at each cadence, "LM
Perplexity" every two LM steps). The learning rates are equal too.

The JAX Trainer runs on zero weights (laid out by jax.eval_shape, so no
init compiles), stub steps and a stub evaluator: its tags and steps follow
the coins and the data, not the losses. Its rng_impl is left empty, so it
keeps JAX's process-wide PRNG setting as it is.
"""
import dataclasses
import os
import struct
import time

import jax
import jax.numpy as jnp
import torch

from e2e_asr_tpu import config as jconfig
from e2e_asr_tpu.core import summary as jsummary
from e2e_asr_tpu.train import loop as jloop
from e2e_asr_tpu_torch.core.summary import NullWriter, SummaryWriter
from e2e_asr_tpu_torch.data import example as pb
from e2e_asr_tpu_torch.data import synth, tfrecord
from e2e_asr_tpu_torch.train.loop import Trainer
from tests.test_torch_recipe import recipe_cfg, write_corpus

torch.set_num_threads(1)


def read_events(summary_dir: str) -> list[tuple]:
    """(tag, step, value) of every scalar event of the one events file in
    summary_dir, after checking the leading file-version event."""
    files = os.listdir(summary_dir)
    assert len(files) == 1 and files[0].startswith("events.out.tfevents.")
    records = list(tfrecord.read_records(os.path.join(summary_dir, files[0]),
                                         verify=True))
    first = {field: value for field, _, value, _ in pb.iter_fields(records[0])}
    assert first[3] == b"brain.Event:2" and first[2] == 0
    out = []
    for record in records[1:]:
        event = {field: value for field, _, value, _ in pb.iter_fields(record)}
        (_, _, value, _), = pb.iter_fields(event[5])
        scalar = {field: v for field, _, v, _ in pb.iter_fields(value)}
        out.append((scalar[1].decode(), event[2],
                    struct.unpack("<f", scalar[2])[0]))
    return out


def _jax_cfg(x):
    """The port's config dataclass as the JAX package's."""
    if dataclasses.is_dataclass(x):
        return getattr(jconfig, type(x).__name__)(**{
            f.name: _jax_cfg(getattr(x, f.name))
            for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: _jax_cfg(v) for k, v in x.items()}
    return x


class _StubEvaluator:
    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, params, batches, write_files=True):
        return 0.5


def test_trainer_summaries_equal_the_jax_trainers(tmp_path, monkeypatch):
    root = str(tmp_path)
    sizes = write_corpus(root, synth)
    port_cfg = recipe_cfg(root, sizes)
    Trainer(port_cfg, device="cpu").train()
    got = read_events(os.path.join(port_cfg.train.train_dir, "summary"))

    jcfg = _jax_cfg(dataclasses.replace(port_cfg, train=dataclasses.replace(
        port_cfg.train, rng_impl="", train_dir=os.path.join(root, "jtrain"),
        best_model_dir=os.path.join(root, "jbest"))))
    monkeypatch.setattr(jloop, "GreedyEvaluator", _StubEvaluator)
    init = jloop.step_lib.init_params
    monkeypatch.setattr(jloop.step_lib, "init_params", lambda key, cfg: (
        jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype),
                               jax.eval_shape(lambda: init(key, cfg)))))
    trainer = jloop.Trainer(jcfg, use_mesh=False)
    loss = {"loss": jnp.float32(3.0), "lm_loss": jnp.float32(3.0)}
    trainer.asr_step = lambda state, batch, key: (
        state._replace(global_step=state.global_step + 1), loss)
    trainer.lm_step = lambda state, *args: (
        state._replace(lm_global_step=state.lm_global_step + 1), loss)
    trainer.train()
    want = read_events(os.path.join(jcfg.train.train_dir, "summary"))

    assert [e[:2] for e in got] == [e[:2] for e in want]
    assert {e[0] for e in got} == {"ASR Perplexity", "Learning rate",
                                   "Frames per sec", "ASR Error",
                                   "LM Perplexity"}
    assert [e for e in got if e[0] == "Learning rate"] == [
        e for e in want if e[0] == "Learning rate"]


def test_writer_bytes_equal_the_jax_writers(tmp_path, monkeypatch):
    """At one wall time, both writers write the same file name and bytes;
    NullWriter writes nothing."""
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    files = []
    for name, cls in (("port", SummaryWriter),
                      ("jax", jsummary.SummaryWriter), ("null", NullWriter)):
        logdir = tmp_path / name
        writer = cls(str(logdir)) if name != "null" else cls()
        writer.scalar("ASR Error", 0.25, 7)
        writer.scalar("Learning rate", 1e-3, 2**40)
        writer.close()
        if name != "null":
            files.append({f: (logdir / f).read_bytes()
                          for f in os.listdir(logdir)})
    assert files[0] == files[1]
    lr = struct.unpack("<f", struct.pack("<f", 1e-3))[0]    # as float32
    assert read_events(str(tmp_path / "port")) == [
        ("ASR Error", 7, 0.25), ("Learning rate", 2**40, lr)]
