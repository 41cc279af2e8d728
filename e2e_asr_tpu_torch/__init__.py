"""PyTorch/CUDA port of e2e_asr_tpu.

The JAX package `e2e_asr_tpu` is the reference; this package computes the
same functions with PyTorch, and every Pallas kernel on a ported path is a
CUDA kernel written for Hopper (`csrc/`, bound in `kernels/`). Parameters
are plain dicts laid out exactly like the JAX pytrees, so the "/"-joined
leaf names of `e2e_asr_tpu.core.checkpoint.flatten_named` load directly
(`core/checkpoint.py`).

Ported so far: the attention family's serving path (encoder, batched beam
search, `eval/serving.BatchingTranscriber`) and its ASR train step
(`train/step.make_train_step`: the training forward with dropout and
scheduled sampling, gradients through hand-written backward kernels, clip +
Adam), float32, LSTM cells. Entry points run on the CUDA card unless the
caller passes device="cpu". What is not ported raises NotImplementedError
naming its ROADMAP.md item. This package imports neither JAX nor the JAX
package: it keeps its own copies of the configuration (`config.py`) and
the vocabulary helpers (`data/text.py`).
"""
