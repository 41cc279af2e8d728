"""Training steps (port of e2e_asr_tpu/train/step.py): the ASR step of the
attention family and the interleaved LM task, each Adam behind global-norm
clipping.

`asr_step(state, batch, gen, noise=None) -> (new_state, metrics)` runs the
training forward (models/seq2seq.apply_train), its gradients by autograd
(on the card through the hand-written backward kernels), then clip + Adam.
`lm_step(state, token_ids, seq_len, gen, valid=None, noise=None)` does the
same for the weight-tied LM (models/rnn_lm.loss, kernels #3 and #5) with
its own Adam slots and step counter over the same parameter tree: the
leaves the LM does not share get zero gradients, and Adam's update of a
zero gradient from zero slots is exactly 0, so their bits do not change.
Both optimizers compute exactly what optax's
chain(clip_by_global_norm(max_norm), inject_hyperparams(adam)
(learning_rate)) computes:
- clip: g * max_norm / ||g|| as (g / norm) * max_norm when norm >= max_norm,
  no epsilon (torch.nn.utils.clip_grad_norm_ adds one and is another
  function);
- Adam: b1 = 0.9, b2 = 0.999, eps = 1e-8 outside the square root, bias
  correction from step 1, the learning rate a value of the state that
  set_lr changes (the decay-on-plateau policy).
The state is functional, as in the reference: a step returns new tensors
and leaves the old state as it was. `state_to_named` / `state_from_named`
give a state the JAX package's checkpoint names, optimizer slots included,
so a checkpoint of either package resumes in the other.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from e2e_asr_tpu_torch.config import LMConfig, Seq2SeqConfig
from e2e_asr_tpu_torch.core.checkpoint import (SEP, _fill, flatten_named,
                                               named_from_params, to_device)
from e2e_asr_tpu_torch.core.device import resolve
from e2e_asr_tpu_torch.models import rnn_lm, seq2seq

B1, B2, EPS = 0.9, 0.999, 1e-8


class AdamState(NamedTuple):
    count: torch.Tensor          # int32 scalar: updates taken
    mu: dict                     # first moments, the params' layout
    nu: dict                     # second moments
    learning_rate: torch.Tensor  # float32 scalar


class TrainState(NamedTuple):
    params: Any
    opt_state: AdamState         # ASR Adam (+clip) state
    lm_opt_state: AdamState      # LM Adam (+clip) state
    global_step: torch.Tensor    # int32 scalar, ASR updates
    lm_global_step: torch.Tensor
    epoch: torch.Tensor
    lm_epoch: torch.Tensor
    ema_params: Any = None


class Optimizer(NamedTuple):
    """Adam behind global-norm clipping (make_optimizer)."""
    learning_rate: float
    max_grad_norm: float

    def init(self, params: dict) -> AdamState:
        leaves = flatten_named(params)
        dev = next(iter(leaves.values())).device
        zeros = {k: torch.zeros_like(v) for k, v in leaves.items()}
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            mu=_fill(params, zeros),
            nu=_fill(params, {k: v.clone() for k, v in zeros.items()}),
            learning_rate=torch.tensor(self.learning_rate,
                                       dtype=torch.float32, device=dev))

    def update(self, grads: dict, state: AdamState, params: dict
               ) -> tuple[dict, AdamState]:
        """(new params, new state) from gradients in the params' layout."""
        g = flatten_named(grads)
        norm = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
        keep = norm < self.max_grad_norm
        g = {k: torch.where(keep, x, (x / norm) * self.max_grad_norm)
             for k, x in g.items()}
        count = state.count + 1
        steps = count.to(torch.float32)
        one = torch.ones((), device=steps.device)
        corr1 = one - torch.pow(one * B1, steps)
        corr2 = one - torch.pow(one * B2, steps)
        mu, nu = flatten_named(state.mu), flatten_named(state.nu)
        p = flatten_named(params)
        new_mu, new_nu, new_p = {}, {}, {}
        for k, x in g.items():
            new_mu[k] = (1 - B1) * x + B1 * mu[k]
            new_nu[k] = (1 - B2) * (x * x) + B2 * nu[k]
            u = (new_mu[k] / corr1) / (torch.sqrt(new_nu[k] / corr2) + EPS)
            new_p[k] = p[k] + u * -state.learning_rate
        return _fill(params, new_p), AdamState(
            count, _fill(params, new_mu), _fill(params, new_nu),
            state.learning_rate)


def make_optimizer(learning_rate: float, max_grad_norm: float,
                   warmup_steps: int = 0) -> Optimizer:
    if warmup_steps > 0:
        raise NotImplementedError("LR warmup is not ported yet (ROADMAP.md "
                                  "Queue 1, 'Training extensions')")
    return Optimizer(learning_rate, max_grad_norm)


def create_state(params: dict, model_cfg: Seq2SeqConfig, lm_cfg: LMConfig,
                 ema: bool = False, *, device=None) -> TrainState:
    """A fresh training state for `params`, moved to `device` (default: the
    CUDA card; raises without one)."""
    if ema:
        raise NotImplementedError("EMA weights are not ported yet "
                                  "(ROADMAP.md Queue 1, 'Training "
                                  "extensions')")
    dev = resolve(device)
    params = to_device(params, dev)
    opt = make_optimizer(model_cfg.learning_rate, model_cfg.max_gradient_norm,
                         model_cfg.lr_warmup_steps)
    lm_opt = make_optimizer(lm_cfg.lm_learning_rate, lm_cfg.max_gradient_norm)
    zero = lambda: torch.zeros((), dtype=torch.int32, device=dev)  # noqa
    return TrainState(params=params, opt_state=opt.init(params),
                      lm_opt_state=lm_opt.init(params), global_step=zero(),
                      lm_global_step=zero(), epoch=zero(), lm_epoch=zero())


def get_lr(state: TrainState) -> float:
    return float(state.opt_state.learning_rate)


def set_lr(state: TrainState, lr: float) -> TrainState:
    """Set the ASR learning rate (the decay op of the plateau policy)."""
    opt = state.opt_state
    new = opt._replace(learning_rate=torch.tensor(
        lr, dtype=torch.float32, device=opt.learning_rate.device))
    return state._replace(opt_state=new)


# The optax state of make_optimizer as the JAX package names its leaves:
# chain index 1 is inject_hyperparams(adam), whose inner state 0 is
# scale_by_adam's (clip_by_global_norm keeps none). Both counts are the
# number of updates taken.
_HYPER = {"b1": B1, "b2": B2, "eps": EPS, "eps_root": 0.0}
_COUNTERS = ("global_step", "lm_global_step", "epoch", "lm_epoch")


def _adam_named(opt: AdamState, prefix: str) -> dict[str, np.ndarray]:
    count = opt.count.detach().cpu().numpy()
    out = {f"{prefix}/1/count": count,
           f"{prefix}/1/inner_state/0/count": count,
           f"{prefix}/1/hyperparams/learning_rate":
               opt.learning_rate.detach().cpu().numpy()}
    for k, v in _HYPER.items():
        out[f"{prefix}/1/hyperparams/{k}"] = np.float32(v)
    for slot in ("mu", "nu"):
        for name, leaf in named_from_params(getattr(opt, slot)).items():
            out[f"{prefix}/1/inner_state/0/{slot}/{name}"] = leaf
    return out


def state_to_named(state: TrainState) -> dict[str, np.ndarray]:
    """The state's leaves by the names the JAX package's checkpoints give
    its TrainState ("params/...", "opt_state/1/inner_state/0/mu/...",
    "global_step", ...), as numpy arrays."""
    out = {f"params{SEP}{k}": v
           for k, v in named_from_params(state.params).items()}
    out.update(_adam_named(state.opt_state, "opt_state"))
    out.update(_adam_named(state.lm_opt_state, "lm_opt_state"))
    for name in _COUNTERS:
        out[name] = getattr(state, name).detach().cpu().numpy()
    return out


def state_from_named(named: dict, template: TrainState) -> TrainState:
    """A TrainState shaped like `template`, on its device, from named leaves
    (state_to_named's, or a JAX checkpoint's). Strict: a missing leaf or a
    shape that differs raises."""
    dev = template.global_step.device

    def tree(like, prefix: str):
        leaves = {}
        for name, leaf in flatten_named(like).items():
            key = f"{prefix}{SEP}{name}"
            if key not in named:
                raise KeyError(f"checkpoint missing leaf: {key}")
            arr = np.asarray(named[key])
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: checkpoint "
                                 f"{arr.shape} vs state {tuple(leaf.shape)}")
            leaves[name] = torch.tensor(arr, dtype=leaf.dtype, device=dev)
        return _fill(like, leaves)

    def scalar(key: str, dtype):
        if key not in named:
            raise KeyError(f"checkpoint missing leaf: {key}")
        return torch.tensor(np.asarray(named[key]), dtype=dtype, device=dev)

    def adam(like: AdamState, prefix: str) -> AdamState:
        inner = f"{prefix}/1/inner_state/0"
        return AdamState(
            count=scalar(f"{inner}/count", torch.int32),
            mu=tree(like.mu, f"{inner}/mu"), nu=tree(like.nu, f"{inner}/nu"),
            learning_rate=scalar(f"{prefix}/1/hyperparams/learning_rate",
                                 torch.float32))

    return template._replace(
        params=tree(template.params, "params"),
        opt_state=adam(template.opt_state, "opt_state"),
        lm_opt_state=adam(template.lm_opt_state, "lm_opt_state"),
        **{name: scalar(name, torch.int32) for name in _COUNTERS})


def _unported(name: str, item: str):
    raise NotImplementedError(f"{name} is not ported yet (ROADMAP.md Queue "
                              f"1, '{item}')")


def make_train_step(model_cfg: Seq2SeqConfig, lm_cfg: LMConfig,
                    compute_dtype=None, spec_augment: bool = False,
                    grad_accum: int = 1, ema_decay: float = 0.0,
                    pp_mesh=None, pp_micro: int = 1, sp_mesh=None,
                    ep_mesh=None, freeze: tuple[str, ...] = (),
                    speed_perturb=None, distill=None,
                    skip_nonfinite: bool = False, *, device=None):
    """Build (asr_step, lm_step) for `device` (default: the CUDA card;
    raises without one). Options the port does not cover raise
    NotImplementedError naming their ROADMAP.md item. Each step exposes
    `.loss_and_grads`, the part before the optimizer."""
    dev = resolve(device)
    seq2seq.check_supported(model_cfg)
    enc = model_cfg.encoder
    checks = [
        (compute_dtype is not None, "bf16 compute", "Decode features"),
        (spec_augment, "SpecAugment", "Frontend"),
        (speed_perturb is not None, "speed perturbation", "Frontend"),
        (grad_accum != 1, "grad_accum > 1", "Training extensions"),
        (ema_decay > 0, "EMA", "Training extensions"),
        (bool(freeze), "freeze", "Training extensions"),
        (skip_nonfinite, "skip_nonfinite", "Training extensions"),
        (distill is not None, "distillation", "Training extensions"),
        (model_cfg.lora_rank > 0, "LoRA", "Training extensions"),
        (enc.remat, "remat", "Training extensions"),
        (any(m is not None for m in (pp_mesh, sp_mesh, ep_mesh)),
         "pp/sp/ep meshes", "Parallelism last"),
        (not enc.use_lstm or not all(d.use_lstm
                                     for d in model_cfg.decoders.values()),
         "GRU cells", "GRU option"),
        (model_cfg.ctc_weight > 0, "the hybrid CTC/attention loss",
         "CTC family"),
    ]
    for bad, name, item in checks:
        if bad:
            _unported(name, item)
    opt = make_optimizer(model_cfg.learning_rate, model_cfg.max_gradient_norm,
                         model_cfg.lr_warmup_steps)
    lm_opt = make_optimizer(lm_cfg.lm_learning_rate, lm_cfg.max_gradient_norm)

    def grads_of(params: dict, loss_fn):
        """loss_fn(params) and its gradients over every leaf of the tree, in
        the params' layout (zeros for the leaves it does not read)."""
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in flatten_named(params).items()}
        loss, aux = loss_fn(_fill(params, leaves))
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)}
        return loss.detach(), aux, _fill(params, grads)

    def loss_and_grads(params: dict, batch: dict, gen: torch.Generator,
                       noise: dict | None = None):
        """(total, per-task losses, grads in the params' layout) of the
        training forward on `batch`: what asr_step hands the optimizer."""
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        return grads_of(params, lambda p: seq2seq.apply_train(
            p, model_cfg, batch, gen=gen, noise=noise))

    def asr_step(state: TrainState, batch: dict, gen: torch.Generator,
                 noise: dict | None = None):
        """One update: (new_state, {"loss": ..., "loss_<task>": ...})."""
        total, per_task, grads = loss_and_grads(state.params, batch, gen,
                                                noise)
        with torch.no_grad():
            new_params, new_opt = opt.update(grads, state.opt_state,
                                             state.params)
        new_state = state._replace(params=new_params, opt_state=new_opt,
                                   global_step=state.global_step + 1)
        metrics = {"loss": total,
                   **{f"loss_{t}": v.detach() for t, v in per_task.items()}}
        return new_state, metrics

    def lm_loss_and_grads(params: dict, token_ids, seq_len,
                          gen: torch.Generator, valid=None, noise=None):
        """(loss, grads in the params' layout) of the LM task on token_ids
        [T, B], seq_len [B] (valid [B] row validity or None; noise the
        output dropout's bool keep-mask [T-1, B, H] or None to draw it from
        gen): what lm_step hands its optimizer."""
        ids, lens = (torch.as_tensor(a, device=dev)
                     for a in (token_ids, seq_len))
        valid = None if valid is None else torch.as_tensor(valid, device=dev)
        loss, _, grads = grads_of(params, lambda p: (rnn_lm.loss(
            p, lm_cfg, ids, lens, train=True, gen=gen, noise=noise,
            valid=valid), None))
        return loss, grads

    def lm_step(state: TrainState, token_ids, seq_len, gen: torch.Generator,
                valid=None, noise=None):
        """One LM update: (new_state, {"lm_loss": ...})."""
        loss, grads = lm_loss_and_grads(state.params, token_ids, seq_len,
                                        gen, valid, noise)
        with torch.no_grad():
            new_params, new_opt = lm_opt.update(grads, state.lm_opt_state,
                                                state.params)
        new_state = state._replace(params=new_params, lm_opt_state=new_opt,
                                   lm_global_step=state.lm_global_step + 1)
        return new_state, {"lm_loss": loss}

    asr_step.loss_and_grads = loss_and_grads
    lm_step.loss_and_grads = lm_loss_and_grads
    return asr_step, lm_step
