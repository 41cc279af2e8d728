"""Weights and checkpoints across frameworks: build the port's parameters
from the named leaves of the JAX package, the named leaves from the port's
parameters, and save / restore checkpoints in the JAX package's layout.

The JAX package names every pytree leaf by its "/"-joined path
(e2e_asr_tpu/core/checkpoint.py `flatten_named`, e.g.
`encoder/layer_1/fw/kernel`, `decoder_char/dec_cells/0/kernel`) and its
checkpoints are `.npz` archives of those names (`checkpoint.save`). The
port's parameter dicts have exactly that layout, so loading is a strict
name-for-name copy: every leaf must be consumed and every shape must match.

Checkpoint directories (port of `save`, `latest_path`, `restore_latest`):
`{prefix}-{step}.npz` files plus a `checkpoint` pointer file naming the
latest, each written to a temporary file and published with os.replace.
With max_to_keep, the GC keeps the newest max_to_keep steps up to the one
the pointer names and never deletes a newer step (one that a writer may be
publishing); the JAX package's sharded GC deletes those too
(checkpoint.py:318-321; ROADMAP.md Queue 3).
"""
from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from e2e_asr_tpu_torch.config import Seq2SeqConfig
from e2e_asr_tpu_torch.core.device import resolve
from e2e_asr_tpu_torch.models import seq2seq

SEP = "/"


def flatten_named(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """{"/"-joined path: leaf} of a parameter dict (lists index by number)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for key, sub in items:
        out.update(flatten_named(sub, f"{prefix}{SEP}{key}" if prefix
                                 else str(key)))
    return out


def to_device(tree, device):
    """A copy of a parameter dict with every tensor on `device` (tensors
    already there are shared, not copied)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree.to(device)


def _fill(template, named: dict, prefix: str = ""):
    if isinstance(template, dict):
        return {k: _fill(v, named, f"{prefix}{SEP}{k}" if prefix else k)
                for k, v in template.items()}
    if isinstance(template, list):
        return [_fill(v, named, f"{prefix}{SEP}{i}")
                for i, v in enumerate(template)]
    return named[prefix]


def params_from_named(named: dict[str, np.ndarray], cfg: Seq2SeqConfig,
                      device=None) -> dict:
    """Build the port's parameters for `cfg` from JAX-named leaves.

    Strict: a leaf the model does not have, a leaf it lacks, or a shape
    that differs raises ValueError. Leaves are copied as float32 to `device`
    (default: the CUDA card; raises without one)."""
    device = resolve(device)
    shapes = seq2seq.init(torch.Generator().manual_seed(0), cfg,
                          device="meta")
    template = flatten_named(shapes)
    missing = sorted(set(template) - set(named))
    unexpected = sorted(set(named) - set(template))
    if missing or unexpected:
        raise ValueError(f"checkpoint leaves do not match the model: "
                         f"missing {missing}, unexpected {unexpected}")
    tensors = {}
    for name, leaf in template.items():
        arr = np.asarray(named[name])
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {name}: checkpoint "
                             f"{arr.shape} vs model {tuple(leaf.shape)}")
        tensors[name] = torch.tensor(arr, dtype=torch.float32, device=device)
    return _fill(shapes, tensors)


def load_npz(path: str, cfg: Seq2SeqConfig, device=None) -> dict:
    """Parameters from a named `.npz` written by the JAX package's
    `checkpoint.save`: a bare parameter tree, or a training state whose
    parameters sit under `params/` (the other state is not read). Default
    device: the CUDA card."""
    named = load_named(path)
    head = "params" + SEP
    if any(k.startswith(head) for k in named):
        named = {k[len(head):]: v for k, v in named.items()
                 if k.startswith(head)}
    return params_from_named(named, cfg, device)


def named_from_params(params: dict) -> dict[str, np.ndarray]:
    """The reverse of params_from_named: {"/"-joined name: float32 numpy
    array}, the form the JAX package's checkpoints and parameters take."""
    return {name: leaf.detach().cpu().numpy()
            for name, leaf in flatten_named(params).items()}


def load_named(path: str) -> dict[str, np.ndarray]:
    """Every named leaf of a `.npz` checkpoint."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def save(ckpt_dir: str, prefix: str, step: int,
         named: dict[str, np.ndarray], meta: dict | None = None,
         max_to_keep: int | None = None) -> str:
    """Write named leaves (train/step.state_to_named's, or
    named_from_params') as {prefix}-{step}.npz and point the `checkpoint`
    file at it. Returns the file's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{prefix}-{step}.npz")
    with open(path + ".tmp", "wb") as f:
        np.savez(f, **named)
    os.replace(path + ".tmp", path)
    pointer = os.path.join(ckpt_dir, "checkpoint")
    with open(pointer + ".tmp", "w") as f:
        json.dump({"latest": os.path.basename(path), "step": step,
                   "meta": meta or {}}, f)
    os.replace(pointer + ".tmp", pointer)
    if max_to_keep:
        _gc(ckpt_dir, prefix, max_to_keep)
    return path


def _gc(ckpt_dir: str, prefix: str, keep: int) -> None:
    """Delete all but the newest `keep` steps at or below the pointer's
    step; steps above it are left alone."""
    pointer = os.path.join(ckpt_dir, "checkpoint")
    if not os.path.isfile(pointer):
        return
    with open(pointer) as f:
        latest = int(json.load(f)["step"])
    pat = re.compile(re.escape(prefix) + r"-(\d+)\.npz$")
    committed = sorted((int(m.group(1)), name)
                       for name in os.listdir(ckpt_dir)
                       if (m := pat.match(name)) and int(m.group(1)) <= latest)
    for _, name in committed[:-keep]:
        os.remove(os.path.join(ckpt_dir, name))


def latest_path(ckpt_dir: str) -> tuple[str, dict] | None:
    """(path of the latest checkpoint, its meta), or None."""
    pointer = os.path.join(ckpt_dir, "checkpoint")
    if not os.path.isfile(pointer):
        return None
    with open(pointer) as f:
        info = json.load(f)
    path = os.path.join(ckpt_dir, info["latest"])
    return (path, info.get("meta", {})) if os.path.isfile(path) else None


def restore_latest(ckpt_dir: str) -> tuple[dict, dict] | None:
    """(named leaves of the latest checkpoint, its meta), or None; a
    training state is rebuilt from them by train/step.state_from_named."""
    found = latest_path(ckpt_dir)
    if found is None:
        return None
    path, meta = found
    return load_named(path), meta
