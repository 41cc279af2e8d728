"""Weights across frameworks: build the port's parameters from the named
leaves of the JAX package, and the named leaves from the port's parameters.

The JAX package names every pytree leaf by its "/"-joined path
(e2e_asr_tpu/core/checkpoint.py `flatten_named`, e.g.
`encoder/layer_1/fw/kernel`, `decoder_char/dec_cells/0/kernel`) and its
checkpoints are `.npz` archives of those names (`checkpoint.save`). The
port's parameter dicts have exactly that layout, so loading is a strict
name-for-name copy: every leaf must be consumed and every shape must match.
"""
from __future__ import annotations

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
    with np.load(path) as data:
        named = {k: data[k] for k in data.files}
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
