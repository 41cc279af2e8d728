"""PyTorch/CUDA port of e2e_asr_tpu.

The JAX package `e2e_asr_tpu` is the reference; this package computes the
same functions with PyTorch, and every Pallas kernel on a ported path is a
CUDA kernel written for Hopper (`csrc/`, bound in `kernels/`). Parameters
are plain dicts laid out exactly like the JAX pytrees, so the "/"-joined
leaf names of `e2e_asr_tpu.core.checkpoint.flatten_named` load directly
(`core/checkpoint.py`).

Ported so far: the attention family's serving path (encoder, batched beam
search, `eval/serving.BatchingTranscriber`), inference only, float32, LSTM
cells. What is not ported raises NotImplementedError naming its ROADMAP.md
item. This package never imports JAX.
"""
