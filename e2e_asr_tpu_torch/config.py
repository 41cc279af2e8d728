"""Configuration dataclasses of the port: a copy of the model, decoder, LM
and beam configurations of e2e_asr_tpu/config.py with the same field names
and defaults (tests/test_torch_config.py holds the two to each other). The
command-line parsing there is not copied: the port has no CLI yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field

@dataclass
class EncoderConfig:
    """Pyramidal (Bi)LSTM/GRU encoder (reference encoder.py:18-31), or the
    Transformer family (models/transformer_encoder.py, encoder_type
    "transformer" — an extension with no reference counterpart)."""
    bi_dir: bool = True
    hidden_size: int = 256
    out_prob: float = 0.9            # dropout keep prob
    skip_step: int = 2               # pyramid time-reduction factor per layer
    initial_res_fac: int = 1         # initial strided subsampling
    use_lstm: bool = True
    stack_cons: int = 1              # frame stacking at input
    max_scaling_down: int = 8        # max total time reduction
    encoder_type: str = "rnn"        # "rnn" | "transformer"
    num_heads: int = 4               # transformer only
    ffn_mult: int = 4                # transformer only
    subsample: int = 8               # transformer input stack-subsampling
    rel_pos_bias: bool = False       # learned relative-position attention
                                     # bias (zero-init; off = sinusoidal only)
    conv_kernel: int = 0             # Conformer-style depthwise-conv module
                                     # per block (kernel size; 0 = off)
    attn_chunk: int = 0              # chunk-causal attention: query frame q
                                     # sees key k iff 0 <= chunk(q)-chunk(k)
                                     # <= attn_left (post-subsample frames
                                     # per chunk; 0 = full attention). Makes
                                     # the conv module causal and enables
                                     # EXACT transformer streaming
                                     # (transformer_encoder.apply_streaming)
    attn_left: int = 8               # chunk-causal left context, in chunks
    moe_experts: int = 0             # Switch-style MoE FFN: experts per
                                     # block (0 = dense FFN); top-1 routing
                                     # with capacity + load-balance aux loss
    moe_capacity: float = 1.25       # expert capacity factor
    moe_aux_weight: float = 0.01     # load-balance aux loss weight
    remat: bool = False              # rematerialize each encoder layer/block
                                     # in backward (jax.checkpoint): per-layer
                                     # activations are recomputed, not stored


@dataclass
class DecoderConfig:
    """Attention decoder (reference decoder.py:21-34, attn_decoder.py:21-28)."""
    out_prob_dec: float = 0.9
    hidden_size_dec: int = 256
    num_layers_dec: int = 1
    emb_size: int = 256
    vocab_size: int = 1000
    samp_prob: float = 0.1           # scheduled sampling prob
    max_output: int = 120
    use_lstm: bool = True
    attention_vec_size: int = 128
    lm_hidden_size: int = 256        # internal "LM LSTM" inside the decoder
    ind_softmax: bool = False        # independent (non-LM-shared) softmax
    joint_dim: int = 256             # transducer family only: width of the
                                     # additive joint (models/transducer.py)
    decoder_type: str = "rnn"        # "rnn" (reference) | "transformer"
                                     # (extension: pre-LN transformer decoder,
                                     # models/transformer_decoder.py —
                                     # d_model = hidden_size_dec, blocks =
                                     # num_layers_dec)
    dec_heads: int = 4               # transformer decoder attention heads
    dec_ffn_mult: int = 4            # transformer decoder FFN width multiple


@dataclass
class LMConfig:
    """RNN-LM task (reference lm_model.py:26-37, lm_encoder.py:22-33)."""
    lm_batch_size: int = 128
    lm_learning_rate: float = 1e-4
    lm_learning_rate_decay_factor: float = 0.5
    max_gradient_norm: float = 5.0
    out_prob: float = 0.9
    lm_hidden_size: int = 256
    proj_size: int = 256
    num_layers: int = 1
    emb_size: int = 256
    vocab_size: int = 1000


@dataclass
class Seq2SeqConfig:
    """Multitask seq2seq assembly (reference seq2seq_model.py:29-48)."""
    tasks: list[str] = field(default_factory=lambda: ["char"])
    num_layers: dict[str, int] = field(default_factory=lambda: {"char": 4})
    max_output: dict[str, int] = field(default_factory=lambda: {"char": 120})
    learning_rate: float = 1e-3
    learning_rate_decay_factor: float = 0.5
    lr_warmup_steps: int = 0         # extension: linear LR warmup (-lr_warmup)
    max_gradient_norm: float = 5.0
    avg: bool = True                 # average loss across tasks
    label_smoothing: float = 0.0     # extension; 0.0 = reference behavior
    ctc_weight: float = 0.0          # extension: hybrid CTC/attention when >0
    model_family: str = "attention"  # extension: "attention" | "ctc"
                                     #            | "transducer"
    lora_rank: int = 0               # extension: LoRA adapters on 2-D
                                     # kernels; base frozen (core/lora.py)
    lora_alpha: float = 0.0          # delta scale alpha/r; 0 = rank (scale 1)
    lora_targets: str = ""           # comma path substrings narrowing the
                                     # adapted kernels ("" = all 2-D kernels)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    decoders: dict[str, DecoderConfig] = field(default_factory=dict)
    feat_length: int = 80

    def __post_init__(self):
        if not self.decoders:
            self.decoders = {t: DecoderConfig(max_output=self.max_output.get(t, 120))
                             for t in self.tasks}


@dataclass
class BeamConfig:
    """Beam search (reference beam_search.py:19-29, flags :340-350)."""
    beam_size: int = 4
    lm_weight: float = 0.0
    lm_path: str = ""
    word_ins_penalty: float = 0.0
    cov_penalty: float = 0.0         # parsed, never applied (beam_search.py:210)
    apply_cov_penalty: bool = False  # extension: GNMT-style coverage penalty
    max_steps: int = 120             # hard cap (beam_search.py:269)
    ctc_rescore: float = 0.0         # extension: hybrid n-best CTC rescoring
    lm_rescore: float = 0.0          # extension: second-pass LM rescoring of
                                     # the beam n-best (score + w*log p_lm)
    joint_ctc: float = 0.0           # extension: one-pass joint CTC/attention
    ctc_pre_beam: int = 0            # joint decoding: CTC-score only the
                                     # attention top-P tokens (0 = full vocab)
    boost_phrases: str = ""          # extension: contextual-biasing phrase file
    boost_weight: float = 0.0        # per-matched-token biasing bonus
    nbest: int = 1                   # extension: write the top-N hypotheses
                                     # per utterance (nbest_*.txt)
    ilm_weight: float = 0.0          # extension: internal-LM subtraction
                                     # during shallow fusion (ILME / HAT)
