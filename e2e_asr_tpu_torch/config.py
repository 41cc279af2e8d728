"""Configuration dataclasses of the port: a copy of the model, decoder, LM,
beam, training and experiment configurations of e2e_asr_tpu/config.py with
the same field names and defaults (tests/test_torch_config.py holds the two
to each other). The command-line parsing there (`process_args`, the
argument parser) is not copied yet: it comes with the CLI (ROADMAP.md
Queue 1). Which TrainConfig fields the port's Trainer honours is stated in
train/loop.py; the others raise there when they differ from their default.
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


@dataclass
class TrainConfig:
    """Training driver (reference train.py:39-72)."""
    batch_size: int = 128
    buck_batch_size: list[int] = field(
        default_factory=lambda: [128, 128, 64, 64, 32])
    max_epochs: int = 30
    min_steps: int = 25000
    feat_length: int = 80
    data_dir: str = "data/tfrecords"
    lm_data_dir: str = "data/tfrecords/lm"
    vocab_dir: str = "data/vocab"
    train_base_dir: str = "models"
    train_dir: str = ""              # derived by process_args
    best_model_dir: str = ""         # derived by process_args
    lm_prob: float = 0.0
    run_id: int = 1
    steps_per_checkpoint: int = 500
    pretrain_lm_path: str = ""
    pretrain_phone_path: str = ""
    pretrain_enc_path: str = ""      # extension: SSL-pretrained encoder
                                     # checkpoint (train/ssl.py) merged into
                                     # a supervised run by pytree path —
                                     # same mechanism as pretrain_lm_path
    ssl: bool = False                # extension: BEST-RQ-style masked-
                                     # prediction pretraining of the encoder
                                     # on unlabeled audio (train/ssl.py)
    ssl_codebook_size: int = 256     # frozen random codebook entries
    ssl_codebook_dim: int = 16       # projection / codebook dimension
    ssl_mask_prob: float = 0.06      # span-start prob per encoder-output
                                     # frame (~27% of frames masked at the
                                     # default span)
    ssl_mask_span: int = 5           # span length in encoder-output frames
                                     # (5 x 80 ms = 400 ms at the flagship's
                                     # 8x reduction — BEST-RQ's choice)
    ssl_steps: int = 0               # stop after this many SSL updates
                                     # (0 = run to max_epochs)
    chaos: bool = False
    subset_file: str = ""
    num_buckets: int = 5
    lr_floor: float = 1e-4           # LR decay floor (train.py:340,346)
    early_stop_window: int = 10      # checkpoints without improvement (train.py:154)
    # TPU-specific
    data_axis: int = -1              # -1: use all devices for data parallelism
    model_axis: int = 1              # devices sharding vocab-sized projections
    fsdp: bool = False               # ZeRO-3: shard params + Adam moments
                                     # over the data axis (core/sharding.py)
    compute_dtype: str = "bfloat16"  # matmul compute dtype on TPU
    profile_dir: str = ""            # jax.profiler trace output (steps 10..15)
    eval_avg_ckpts: int = 1          # eval the mean of the last N ckpts (>1)
    rng_impl: str = "rbg"            # dropout/sampling PRNG ("rbg" is ~2x
                                     # cheaper than threefry on TPU; set
                                     # "threefry2x32" for cross-version
                                     # reproducibility)
    spec_augment: bool = False       # on-device SpecAugment masking (off by
                                     # default for reference parity)
    async_ckpt: bool = False         # overlap checkpoint writes with
                                     # training (core/checkpoint.py
                                     # AsyncCheckpointer)
    grad_accum: int = 1              # micro-batches per optimizer update
                                     # (train/step.py): activation memory
                                     # drops ~N-fold, update = full batch
    ema_decay: float = 0.0           # Polyak/EMA shadow weights updated
                                     # after every step (0 = off); dev-WER
                                     # selection + -eval_ema use them
    eval_ema: bool = False           # eval CLI decodes the EMA weights
                                     # (requires a -ema_decay checkpoint)
    compile_cache: str = ""          # persistent XLA compilation-cache dir:
                                     # recompiles across process restarts
                                     # become disk hits (serving cold-start)
    quantize: str = ""               # "int8": eval/serving decodes int8
                                     # weight-only quantized params
                                     # (core/quant.py)
    score_unit: str = "word"         # "char": report CER instead of WER
    freeze: str = ""                 # comma-separated pytree-path substrings
                                     # trained with zero gradient
    speed_perturb: str = ""          # "lo,hi": per-utterance tempo
                                     # augmentation factors (e.g. 0.9,1.1)
    distill_dir: str = ""            # teacher run dir for knowledge
                                     # distillation (train/distill.py)
    distill_weight: float = 0.5      # KL share of the distilled loss
    distill_temp: float = 2.0        # distillation softmax temperature
    mwer: bool = False               # minimum-WER sequence fine-tuning
                                     # (train/mwer.py) instead of CE
    mwer_nbest: int = 4              # n-best size for the MWER expectation
    mwer_ce: float = 0.01            # CE anchor weight in the MWER loss
    skip_nonfinite: bool = False     # on-device guard: a non-finite loss or
                                     # gradient skips the whole update (the
                                     # state keeps its pre-step value) with
                                     # no host sync (train/step.py)
    nan_recover: int = 0             # when the checkpoint-cadence loss goes
                                     # non-finite: restore the latest
                                     # checkpoint and halve the LR, up to
                                     # this many times (0 = just stop; the
                                     # run never keeps training on NaN)
    platform: str = ""               # force a jax platform ("cpu"/"tpu")
                                     # BEFORE backend init — env
                                     # JAX_PLATFORMS alone can be overridden
                                     # by interpreter-startup hooks
    dist_coordinator: str = ""       # host:port of process 0 — multi-host
                                     # (jax.distributed) training; each host
                                     # runs the same CLI with its own
                                     # -dist_pid (cli/main.py initializes
                                     # before any jax use)
    dist_nprocs: int = 1             # total processes in the job
    dist_pid: int = 0                # this process's index
    pp_stages: int = 1               # pipeline-parallel stages for the
                                     # transformer block stack
                                     # (core/pipeline.py); 1 = off
    pp_micro: int = 2                # microbatches per pipeline step
                                     # (must divide each bucket batch)
    sp_shards: int = 1               # sequence-parallel time shards for
                                     # the transformer blocks
                                     # (core/seq_parallel.py); 1 = off
    ep_shards: int = 1               # expert-parallel shards for MoE FFNs
                                     # (core/expert_parallel mesh threaded
                                     # into the transformer blocks); 1 = off


@dataclass
class ExperimentConfig:
    model: Seq2SeqConfig = field(default_factory=Seq2SeqConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    lm: LMConfig = field(default_factory=LMConfig)
    beam: BeamConfig = field(default_factory=BeamConfig)
    dev: bool = False
    test: bool = False
