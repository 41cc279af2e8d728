"""Command line of the port: train or evaluate (dev/test), a port of
e2e_asr_tpu/cli/main.py.

Parses every flag of the JAX command (e2e_asr_tpu_torch/config.py
`add_parse_options`), derives the run-name-encoding train directory, loads
the vocabularies to size the decoders, writes parameters.txt (the same
bytes as the JAX command's for the same flags) and dispatches: training to
the port's Trainer; `-dev` / `-test` evaluation to the greedy evaluator
when beam_size is 1 and no beam feature is set, else to the beam
evaluator (kernel #15's route at dev/test batches of 1 or 2, the per-step
route above and for `-joint_ctc`, joint CTC/attention decoding of a
hybrid checkpoint trained with `-ctc_weight`); with `-model_family ctc`,
to the CTC evaluator (best path at beam size 1, the prefix beam search
above); with `-model_family transducer`, to the transducer evaluator
(greedy at beam size 1, its beam search above).

Usage (the port has no bf16: pass -compute_dtype float32):
    python -m e2e_asr_tpu_torch.cli.main -compute_dtype float32 [flags]
    python -m e2e_asr_tpu_torch.cli.main -compute_dtype float32 -dev ...
    python -m e2e_asr_tpu_torch.cli.main -compute_dtype float32 -test ...
It runs on the CUDA card, and raises without one; `-platform cpu` runs on
the CPU through the kernels' plain versions.

What the port does not honour raises NotImplementedError naming its
ROADMAP.md item: bf16 compute, multi-host runs (-dist_coordinator), the
TrainConfig options in train/loop.py `UNPORTED` (EMA, int8, checkpoint
averaging, meshes, ...), LoRA, biasing, -lm_path, -ctc_rescore, the beam
features eval/beam.py lists and the CTC and transducer families' n-best
and lm_rescore.
"""
from __future__ import annotations

import argparse
import glob
import os
import time
from os import path

import torch

from e2e_asr_tpu_torch import config as config_lib
from e2e_asr_tpu_torch.config import ExperimentConfig

TODO = "is not ported yet (ROADMAP.md Queue 1, '{}')"


def parse_options(argv=None) -> ExperimentConfig:
    parser = argparse.ArgumentParser()
    config_lib.add_parse_options(parser)
    args = vars(parser.parse_args(argv))

    # Load vocabularies to size the decoders (main.py:108-113).
    tasks = config_lib.parse_tasks(args.get("tasks", ""))
    vocab_sizes = {}
    from e2e_asr_tpu_torch.data import text
    for task in tasks:
        vocab_path = path.join(args["vocab_dir"], f"{task}.vocab")
        if path.isfile(vocab_path):
            vocab, _ = text.initialize_vocabulary(vocab_path)
            vocab_sizes[task] = len(vocab)

    cfg = config_lib.process_args(args, vocab_sizes)
    if cfg.train.compute_dtype == "bfloat16":
        raise NotImplementedError(
            "bf16 compute " + TODO.format("Decode features")
            + ": pass -compute_dtype float32")

    if not cfg.dev and not cfg.test:
        os.makedirs(cfg.train.train_dir, exist_ok=True)
        os.makedirs(cfg.train.best_model_dir, exist_ok=True)
        with open(path.join(cfg.train.train_dir, "parameters.txt"),
                  "w") as f:
            f.write(config_lib.config_to_text(cfg) + "\n")
    return cfg


def select_device(cfg: ExperimentConfig) -> torch.device:
    """-platform: empty, "gpu" or "cuda" is the CUDA card (raises without
    one); "cpu" the CPU."""
    tc = cfg.train
    if tc.dist_coordinator:
        raise NotImplementedError("multi-host runs (-dist_coordinator) "
                                  + TODO.format("Parallelism last"))
    if tc.platform in ("", "gpu", "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the card; "
                               "pass -platform cpu to run on the CPU")
        return torch.device("cuda")
    if tc.platform == "cpu":
        return torch.device("cpu")
    raise ValueError(f"-platform {tc.platform!r}: the port runs on the CUDA "
                     "card ('', 'gpu' or 'cuda') or on the CPU ('cpu')")


def launch_train(cfg: ExperimentConfig, device) -> None:
    from e2e_asr_tpu_torch.train.loop import Trainer
    Trainer(cfg, device=device).train()


def launch_eval(cfg: ExperimentConfig, device) -> None:
    from e2e_asr_tpu_torch.core import checkpoint as ckpt_lib
    from e2e_asr_tpu_torch.data import text
    from e2e_asr_tpu_torch.data.speech import SpeechDataset
    from e2e_asr_tpu_torch.eval.beam_eval import BeamEvaluator
    from e2e_asr_tpu_torch.eval.greedy import (CTCEvaluator,
                                               GreedyEvaluator,
                                               TransducerEvaluator)
    from e2e_asr_tpu_torch.train import step as step_lib
    from e2e_asr_tpu_torch.train.loop import Trainer

    tc, bc = cfg.train, cfg.beam
    if bc.lm_path:
        raise NotImplementedError("-lm_path (the fusion LM) "
                                  + TODO.format("Decode features"))
    if bc.boost_phrases and bc.boost_weight != 0.0:
        raise NotImplementedError("contextual biasing "
                                  + TODO.format("Decode features"))
    # Raises for what the port's Trainer, train step and model do not
    # cover (EMA, int8, checkpoint averaging, meshes, families, LoRA, ...).
    trainer = Trainer(cfg, device=device)
    if cfg.dev:
        _, dev_set = trainer.get_data_sets()
    else:
        test_files = sorted(glob.glob(path.join(tc.data_dir, "eval2000*")))
        print(f"Total test files: {len(test_files)}")
        dev_set = SpeechDataset(test_files, 64, tc.feat_length,
                                is_training=False, tasks=("char",))

    # Restore: prefer best_model_dir, else train_dir, else fresh init
    # (main.py:203-215).
    params = step_lib.init_params(torch.Generator().manual_seed(10),
                                  cfg.model, device=device)
    state = step_lib.create_state(params, cfg.model, cfg.lm, device=device)
    ckpt_path = None
    for d in (tc.best_model_dir, tc.train_dir):
        found = ckpt_lib.latest_path(d)
        if found:
            ckpt_path = found[0]
            state = step_lib.state_from_named(ckpt_lib.load_named(ckpt_path),
                                              state)
            break
    print(f"Using the model from: {ckpt_path}")

    _, rev_vocab = text.initialize_vocabulary(
        path.join(tc.vocab_dir, "char.vocab"))
    start = time.time()
    if cfg.model.model_family == "ctc":
        if bc.ilm_weight != 0.0:
            raise ValueError("-ilm_weight needs a decoder with an internal "
                             "LM (attention or transducer family); pure CTC "
                             "has none — its fusion is already density-free")
        evaluator = CTCEvaluator(
            cfg.model, rev_vocab, tc.best_model_dir, beam_size=bc.beam_size,
            lm_weight=bc.lm_weight, lm_rescore=bc.lm_rescore,
            nbest=bc.nbest, device=device)
    elif cfg.model.model_family == "transducer":
        evaluator = TransducerEvaluator(
            cfg.model, rev_vocab, tc.best_model_dir, beam_size=bc.beam_size,
            lm_weight=bc.lm_weight, ilm_weight=bc.ilm_weight,
            lm_rescore=bc.lm_rescore, nbest=bc.nbest, device=device)
    elif (bc.beam_size == 1 and bc.lm_weight == 0.0 and bc.ctc_rescore == 0.0
            and bc.joint_ctc == 0.0 and bc.ilm_weight == 0.0
            and bc.lm_rescore == 0.0 and bc.nbest <= 1):
        evaluator = GreedyEvaluator(cfg.model, rev_vocab, tc.best_model_dir,
                                    device=device)
    else:
        evaluator = BeamEvaluator(cfg.model, bc, rev_vocab,
                                  tc.best_model_dir, nbest=bc.nbest,
                                  device=device)
    evaluator.score_unit = tc.score_unit
    evaluator(state.params, dev_set.epoch())
    print(f"Total decoding time: {time.time() - start:.1f}s")


def main(argv=None) -> None:
    cfg = parse_options(argv)
    device = select_device(cfg)
    if cfg.dev or cfg.test:
        launch_eval(cfg, device)
    else:
        launch_train(cfg, device)


if __name__ == "__main__":
    main()
