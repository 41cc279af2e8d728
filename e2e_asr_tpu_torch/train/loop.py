"""Training driver (port of e2e_asr_tpu/train/loop.py `Trainer`, its
reference path): bucket scheduling, the LM/ASR interleave, and the
checkpoint, LR-decay and early-stop policies of the recipe:

- length buckets with their own batch sizes, drained smallest first each
  epoch;
- per step, an `lm_prob` coin picks the LM task; the LM has its own
  optimizer slots and step counter and shares the parameter tree, and it
  counts its own epochs;
- every `steps_per_checkpoint` ASR steps: perplexity and LR, greedy dev WER
  (asr_err.txt), LR decay when the dev error is no better than the worst of
  the previous 3 checkpoints after min_steps (down to lr_floor), early stop
  when the best has not improved over early_stop_window checkpoints at the
  floor LR, the best-model save (2 kept) and the train-dir save;
- resume from the latest checkpoint of train_dir;
- TensorBoard summaries in train_dir/summary (core/summary.py), under the
  JAX Trainer's tags and at its global steps: "ASR Perplexity", "Learning
  rate" and "Frames per sec" each cadence, "ASR Error" with each dev
  score, "LM Perplexity" every steps_per_checkpoint LM steps.

The steps run on `device` (default: the CUDA card): on the card through
the hand-written kernels, on the CPU through their plain versions. The
randomness of the steps (dropout, scheduled sampling, the LM's dropout) is
drawn from one torch.Generator on that device, seeded as the reference
seeds its key; the coins and the data order use the reference's seeds.

Every model family trains: the attention family (with a CTC head and
the hybrid loss where ctc_weight > 0), the CTC family (its dev WER through
eval/greedy.CTCEvaluator, best path) and the transducer family (through
eval/greedy.TransducerEvaluator, greedy). TrainConfig fields the port does
not honour raise NotImplementedError, naming their ROADMAP.md item, when
they differ from their default (`UNPORTED`); so does bf16 compute (set
compute_dtype="float32"). Before its first
step, `train` raises ValueError where the LM task would run on a GRU char
decoder (the JAX package has no GRU LM, models/rnn_lm.py). `platform` and `score_unit` are
the command line's (cli/main.py), as in the JAX package, whose Trainer
reads neither.
"""
from __future__ import annotations

import glob
import math
import os
import random
import time
from os import path

import numpy as np
import torch

from e2e_asr_tpu_torch.config import ExperimentConfig, TrainConfig
from e2e_asr_tpu_torch.core import checkpoint as ckpt_lib
from e2e_asr_tpu_torch.core.device import resolve
from e2e_asr_tpu_torch.core.summary import SummaryWriter
from e2e_asr_tpu_torch.data import text
from e2e_asr_tpu_torch.data.lm import LMDataset
from e2e_asr_tpu_torch.data.speech import SpeechDataset, prefetch
from e2e_asr_tpu_torch.eval.greedy import (CTCEvaluator, GreedyEvaluator,
                                           TransducerEvaluator)
from e2e_asr_tpu_torch.models import rnn_lm
from e2e_asr_tpu_torch.train import step as step_lib

# TrainConfig field -> ROADMAP.md Queue 1 item that will honour it.
UNPORTED = {
    "pretrain_lm_path": "Training extensions",
    "pretrain_phone_path": "Training extensions",
    "pretrain_enc_path": "Training extensions",
    "ssl": "Training extensions",
    "spec_augment": "Frontend",
    "speed_perturb": "Frontend",
    "grad_accum": "Training extensions",
    "ema_decay": "Training extensions",
    "eval_ema": "Training extensions",
    "freeze": "Training extensions",
    "distill_dir": "Training extensions",
    "mwer": "Training extensions",
    "skip_nonfinite": "Training extensions",
    "nan_recover": "Training extensions",
    "async_ckpt": "Training extensions",
    "profile_dir": "Training extensions",
    "rng_impl": "Training extensions",
    "compile_cache": "Training extensions",
    "quantize": "Decode features",
    "eval_avg_ckpts": "Tools",
    "data_axis": "Parallelism last",
    "model_axis": "Parallelism last",
    "fsdp": "Parallelism last",
    "dist_coordinator": "Parallelism last",
    "dist_nprocs": "Parallelism last",
    "dist_pid": "Parallelism last",
    "pp_stages": "Parallelism last",
    "sp_shards": "Parallelism last",
    "ep_shards": "Parallelism last",
}


def check_progress(previous_errs: list[float], num: int = 10) -> bool:
    """False when the best error hasn't improved in the last `num`
    checkpoints."""
    if len(previous_errs) > num:
        if min(previous_errs) != min(previous_errs[-num:]):
            return False
    return True


def check_supported(tc: TrainConfig) -> None:
    defaults = TrainConfig()
    for name, item in UNPORTED.items():
        if getattr(tc, name) != getattr(defaults, name):
            raise NotImplementedError(f"TrainConfig.{name} is not ported yet "
                                      f"(ROADMAP.md Queue 1, '{item}')")
    if tc.compute_dtype == "bfloat16":
        raise NotImplementedError("bf16 compute is not ported yet (ROADMAP.md"
                                  " Queue 1, 'Decode features'): set "
                                  "compute_dtype='float32'")
    if not (tc.train_dir and tc.best_model_dir):
        raise ValueError("set train_dir and best_model_dir (the JAX "
                         "package's process_args derives them)")


class Trainer:
    def __init__(self, cfg: ExperimentConfig, *, device=None):
        self.cfg = cfg
        self.model_cfg = cfg.model
        self.train_cfg = cfg.train
        self.lm_cfg = cfg.lm
        self.device = resolve(device)
        check_supported(self.train_cfg)
        self.asr_step, self.lm_step = step_lib.make_train_step(
            self.model_cfg, self.lm_cfg, device=self.device)

    # ------------------------------------------------------------------
    # Data
    # ------------------------------------------------------------------
    def get_data_sets(self):
        tc = self.train_cfg
        tasks = tuple(self.model_cfg.tasks)
        buckets = []
        total = 0
        for bucket_id, batch_size in enumerate(
                tc.buck_batch_size[: tc.num_buckets]):
            files = sorted(glob.glob(
                path.join(tc.data_dir, f"train_1k.{bucket_id}.*")))
            if tc.subset_file:
                keep = set()
                try:
                    with open(tc.subset_file) as f:
                        keep = {line.strip() for line in f}
                except OSError:
                    keep = set()
                if keep:
                    files = [f for f in files if path.basename(f) in keep]
            total += len(files)
            if not files:
                continue
            buckets.append(SpeechDataset(
                files, batch_size, tc.feat_length, is_training=True,
                tasks=tasks, seed=self._seed()))
        print(f"Total train files: {total}")
        dev_files = sorted(glob.glob(path.join(tc.data_dir, "dev*")))
        print(f"Total dev files: {len(dev_files)}")
        dev_set = (SpeechDataset(dev_files, tc.batch_size, tc.feat_length,
                                 is_training=False, tasks=("char",))
                   if dev_files else None)
        return buckets, dev_set

    def get_lm_dataset(self):
        files = sorted(glob.glob(path.join(self.train_cfg.lm_data_dir, "lm*")))
        if not files:
            return None
        return LMDataset(files, self.lm_cfg.lm_batch_size, seed=self._seed())

    def _seed(self) -> int:
        return int(time.time()) if self.train_cfg.chaos else 10

    def _place_batch(self, batch: dict):
        """The batch's arrays on the device, started in the prefetch
        thread. Returns (frame_count, device_batch)."""
        dev_b = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items() if k != "utt_ids"}
        return int(np.sum(batch["logmel_len"])), dev_b

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def train(self) -> step_lib.TrainState:
        """Train to max_epochs or an early stop; returns the final state."""
        cfg, tc = self.model_cfg, self.train_cfg
        if not tc.chaos:
            random.seed(10)
            np.random.seed(10)
        else:
            random.seed(int(time.time()))

        os.makedirs(tc.train_dir, exist_ok=True)
        os.makedirs(tc.best_model_dir, exist_ok=True)

        params = step_lib.init_params(torch.Generator().manual_seed(
            10 if not tc.chaos else int(time.time())), cfg,
            device=self.device)
        state = step_lib.create_state(params, cfg, self.lm_cfg,
                                      device=self.device)
        restored = ckpt_lib.restore_latest(tc.train_dir)
        if restored is not None:
            state = step_lib.state_from_named(restored[0], state)
            print(f"Resumed from step {int(state.global_step)}")

        buckets, dev_set = self.get_data_sets()
        lm_data = self.get_lm_dataset() if tc.lm_prob > 0 else None
        lm_iter = None

        rev_vocab = self._load_rev_vocab()
        eval_cls = {"ctc": CTCEvaluator,
                    "transducer": TransducerEvaluator}.get(
            cfg.model_family, GreedyEvaluator)
        evaluator = (eval_cls(cfg, rev_vocab, tc.best_model_dir,
                              device=self.device)
                     if dev_set is not None and rev_vocab else None)
        if lm_data is not None:
            rnn_lm.check_cell(cfg.decoders["char"].use_lstm)
        writer = SummaryWriter(path.join(tc.train_dir, "summary"))

        asr_err_best = self._read_best()
        previous_errs = self._read_err_history()
        if previous_errs and not (step_lib.get_lr(state) > tc.lr_floor):
            if not check_progress(previous_errs, tc.early_stop_window):
                print("No improvement in 10 checkpoints")
                writer.close()
                return state

        print(f"\nBest ASR error rate - {asr_err_best:f}")
        gen = torch.Generator(device=self.device).manual_seed(self._seed())
        epoch = int(state.epoch)
        current_step = 0
        # Loss accumulators stay on the device: reading them every step
        # would wait for each step to finish.
        loss_acc = torch.zeros((), device=self.device)
        lm_loss_acc = torch.zeros((), device=self.device)
        lm_steps = 0
        self._frames_acc = 0
        ckpt_start = time.time()
        stop = False

        while epoch <= tc.max_epochs and not stop:
            print(f"\nEpochs done: {epoch}")
            epc_start = time.time()
            # Smallest-utterance buckets drain first; batch assembly and the
            # copy to the device run one batch ahead in a thread.
            bucket_iters = [prefetch(map(self._place_batch, b.epoch()), size=2)
                            for b in buckets]
            bucket_idx = 0
            while bucket_idx < len(bucket_iters) and not stop:
                task = "lm" if (tc.lm_prob > random.random()) else "asr"
                if task == "lm" and lm_data is not None:
                    if lm_iter is None:
                        lm_iter = iter(lm_data.epoch())
                    lm_batch = next(lm_iter, None)
                    if lm_batch is None:
                        lm_iter = iter(lm_data.epoch())  # reshuffle
                        state = state._replace(lm_epoch=state.lm_epoch + 1)
                        print(f"LM Epoch done !! (epoch {int(state.lm_epoch)})")
                        continue
                    state, metrics = self.lm_step(
                        state, lm_batch["char"].T, lm_batch["char_len"], gen,
                        lm_batch["valid"])
                    lm_loss_acc = lm_loss_acc + metrics["lm_loss"]
                    lm_steps += 1
                    if lm_steps % tc.steps_per_checkpoint == 0:
                        mean_l = float(lm_loss_acc) / tc.steps_per_checkpoint
                        ppl = math.exp(mean_l) if mean_l < 300 else float("inf")
                        print(f"LM steps: {int(state.lm_global_step)}, "
                              f"Perplexity: {ppl:f}")
                        writer.scalar("LM Perplexity", ppl,
                                      int(state.global_step))
                        lm_loss_acc = torch.zeros((), device=self.device)
                    continue

                item = next(bucket_iters[bucket_idx], None)
                if item is None:
                    bucket_idx += 1
                    continue
                batch_frames, dev_b = item
                state, metrics = self.asr_step(state, dev_b, gen)
                current_step += 1
                self._frames_acc += batch_frames
                # char-CE for the perplexity summary
                loss_acc = loss_acc + metrics.get("loss_char", metrics["loss"])

                if current_step % tc.steps_per_checkpoint == 0:
                    mean_loss = float(loss_acc) / tc.steps_per_checkpoint
                    state, asr_err_best, stop = self._checkpoint_cadence(
                        state, writer, evaluator, dev_set, mean_loss,
                        previous_errs, asr_err_best, ckpt_start)
                    loss_acc = torch.zeros((), device=self.device)
                    ckpt_start = time.time()

            print(f"Total steps: {int(state.global_step)}")
            state = state._replace(epoch=state.epoch + 1)
            epoch += 1
            print(f"\nEPOCH TIME: {time.time() - epc_start:.1f}s\n")
            print("Reshuffling ASR training data!")
        writer.close()
        return state

    # ------------------------------------------------------------------
    def _checkpoint_cadence(self, state, writer, evaluator, dev_set,
                            loss_acc, previous_errs, asr_err_best,
                            ckpt_start):
        tc = self.train_cfg
        stop = False
        if not math.isfinite(loss_acc):
            # The run has diverged: never checkpoint or decode a non-finite
            # state. Restoring with a halved LR (nan_recover) is not ported.
            self._frames_acc = 0
            print("Non-finite training loss detected !!")
            print(f"Stopping: recovery budget exhausted ({tc.nan_recover} "
                  f"allowed)")
            return state, asr_err_best, True
        gstep = int(state.global_step)
        lr = step_lib.get_lr(state)
        ppl = math.exp(loss_acc) if loss_acc < 300 else float("inf")
        elapsed = time.time() - ckpt_start
        frames_per_sec = self._frames_acc / max(elapsed, 1e-9)
        self._frames_acc = 0
        print(f"Step {gstep} Learning rate {lr:.4f} Checkpoint time "
              f"{elapsed:.2f} Perplexity {ppl:.2f} "
              f"Frames/sec {frames_per_sec:,.0f}")
        writer.scalar("ASR Perplexity", ppl, gstep)
        writer.scalar("Learning rate", lr, gstep)
        writer.scalar("Frames per sec", frames_per_sec, gstep)

        if evaluator is not None and dev_set is not None:
            t0 = time.time()
            asr_err_cur = evaluator(state.params, dev_set.epoch())
            print(f"ASR error: {asr_err_cur:.4f}, Decoding time: "
                  f"{time.time() - t0:.1f}s")
            with open(path.join(tc.train_dir, "asr_err.txt"), "a") as f:
                f.write(str(asr_err_cur) + "\n")
            writer.scalar("ASR Error", asr_err_cur, gstep)

            if gstep >= tc.min_steps:
                if (len(previous_errs) > 3
                        and asr_err_cur >= max(previous_errs[-3:])):
                    if lr > tc.lr_floor:
                        state = step_lib.set_lr(
                            state, lr * self.model_cfg.learning_rate_decay_factor)
                        print("Learning rate decreased !!")
            previous_errs.append(asr_err_cur)
            if not (step_lib.get_lr(state) > tc.lr_floor):
                if not check_progress(previous_errs, tc.early_stop_window):
                    print("No improvement in 10 checkpoints")
                    stop = True

            if asr_err_best > asr_err_cur:
                asr_err_best = asr_err_cur
                print(f"Best ASR Error rate: {asr_err_best:.4f}")
                print("Saving the best model !!")
                with open(path.join(tc.train_dir, "best.txt"), "w") as f:
                    f.write(str(asr_err_best))
                self._save(tc.best_model_dir, gstep, state,
                           meta={"best": asr_err_best}, max_to_keep=2)

        self._save(tc.train_dir, gstep, state, meta={"best": asr_err_best})
        return state, asr_err_best, stop

    def _save(self, ckpt_dir, gstep, state, *, meta, max_to_keep=None):
        ckpt_lib.save(ckpt_dir, "asr.ckpt", gstep,
                      step_lib.state_to_named(state), meta=meta,
                      max_to_keep=max_to_keep)

    def _read_best(self) -> float:
        score_file = path.join(self.train_cfg.train_dir, "best.txt")
        if path.isfile(score_file):
            try:
                return float(open(score_file).readline().strip())
            except ValueError:
                pass
        return 1.0

    def _read_err_history(self) -> list[float]:
        errs = []
        try:
            with open(path.join(self.train_cfg.train_dir, "asr_err.txt")) as f:
                errs = [float(line.strip()) for line in f]
            print(f"Previous perf. log of {len(errs)} checkpoints loaded")
        except (OSError, ValueError):
            pass
        return errs

    def _load_rev_vocab(self):
        vocab_path = path.join(self.train_cfg.vocab_dir, "char.vocab")
        if not path.isfile(vocab_path):
            return None
        _, rev = text.initialize_vocabulary(vocab_path)
        return rev
