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
(`train/loop.Trainer`); the command line (`cli/main.py`: train, `-dev`,
`-test`), beam evaluation (`eval/beam_eval.BeamEvaluator`) and the beam
grid (`tools/beam_grid.py`), with the whole search of a batch of 1-2
utterances in one launch (kernel #15); float32, for the LSTM and the GRU
(`-gru`) families alike, TensorBoard summaries included. Entry points
run on the CUDA card unless the caller passes device="cpu" (`-platform
cpu` on the command line). What is not ported raises
NotImplementedError naming its ROADMAP.md item. This package imports
neither JAX nor the JAX package: it keeps its own copies of what it needs
from the JAX-free modules (`config.py`, `data/`, `eval/score.py`).
"""
