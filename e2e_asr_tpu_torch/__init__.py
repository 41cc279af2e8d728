"""PyTorch/CUDA port of e2e_asr_tpu.

The JAX package `e2e_asr_tpu` is the reference; this package computes the
same functions with PyTorch, and every Pallas kernel on a ported path is a
CUDA kernel written for Hopper (`csrc/`, bound in `kernels/`). Parameters
are plain dicts laid out exactly like the JAX pytrees, so the "/"-joined
leaf names of `e2e_asr_tpu.core.checkpoint.flatten_named` load directly
(`core/checkpoint.py`).

Ported so far: the attention family's serving path (encoder, batched beam
search, `eval/serving.BatchingTranscriber`) and its training recipe: the
ASR and LM steps (`train/step.make_train_step`: the training forwards with
dropout and scheduled sampling, gradients through hand-written backward
kernels, clip + Adam), the phone multitask, greedy dev WER
(`eval/greedy.GreedyEvaluator`), checkpoints and the driver
(`train/loop.Trainer`); float32, LSTM cells. Entry points run on the CUDA
card unless the caller passes device="cpu". What is not ported raises
NotImplementedError naming its ROADMAP.md item. This package imports
neither JAX nor the JAX package: it keeps its own copies of what it needs
from the JAX-free modules (`config.py`, `data/`, `eval/score.py`).
"""
