"""Configuration of the port: a copy of e2e_asr_tpu/config.py, the
dataclasses with the same field names and defaults, and the command-line
layer with every flag of the JAX parser (same names, aliases, defaults and
types), the run-directory name, `process_args` and the parameters.txt
dump and its inverse (tests/test_torch_config.py and tests/test_torch_cli.py
hold the two packages to each other).

Left out: `enable_compilation_cache`, which points JAX's compilation cache
at a directory; `-compile_cache` raises in the Trainer (train/loop.py
`UNPORTED`). The parser accepts every flag; what the port does not honour
raises NotImplementedError naming its ROADMAP.md item where it is used
(train/loop.py, cli/main.py, eval/).
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any

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


def get_run_dir_name(opts: dict[str, Any]) -> str:
    """Derive the run-identity directory name from the config — identical
    scheme to the reference (main.py:62-87)."""
    num_layer_string = ""
    for task in opts["tasks"]:
        if task == "char":
            continue
        num_layer_string += task + "_" + str(opts["num_layers_" + task]) + "_"
    skip_string = ""
    if opts["skip_step"] != 1:
        skip_string = "skip_" + str(opts["skip_step"]) + "_"
    # Extension: the transformer encoder family gets its own run-dir prefix
    # (the reference scheme has no such knob; RNN runs keep identical names).
    xfmr_string = ""
    if opts.get("encoder_type", "rnn") == "transformer":
        xfmr_string = "xfmr_" + str(opts.get("num_heads", 4)) + "h_"
        if opts.get("attn_chunk", 0) > 0:
            xfmr_string += ("chunk_" + str(opts["attn_chunk"]) + "x"
                            + str(opts.get("attn_left", 8)) + "_")
    if opts.get("decoder_type", "rnn") == "transformer":
        xfmr_string += ("xdec_" + str(opts.get("num_layers_dec", 1)) + "x"
                        + str(opts.get("dec_heads", 4)) + "h_")
    if opts.get("ctc_weight", 0.0) > 0:
        xfmr_string += "ctc_w" + str(opts["ctc_weight"]) + "_"
    if opts.get("model_family", "attention") == "ctc":
        xfmr_string += "ctcfam_"
    if opts.get("model_family", "attention") == "transducer":
        xfmr_string += "rnnt_"
    if opts.get("ssl"):
        # SSL pretraining runs get their own run-dir namespace so a
        # same-config supervised run never resumes from an SSL checkpoint.
        xfmr_string = "ssl_" + xfmr_string
    if opts.get("lora_rank", 0):
        # LoRA fine-tunes get their own run dir so they never resume (or
        # shadow) the base run they warm-start from (-pretrain_lm_path).
        xfmr_string += "lora_r" + str(opts["lora_rank"]) + "_"
    return (xfmr_string + skip_string + num_layer_string +
            ("lstm_" if opts["use_lstm"] else "") +
            (("stack_" + str(opts["stack_cons"]) + "_")
             if opts["stack_cons"] > 1 else "") +
            (("base_stride_" + str(opts["initial_res_fac"]) + "_")
             if opts["initial_res_fac"] > 1 else "") +
            (("char_dec_dep_" + str(opts["num_layers_dec"]) + "_")
             if opts["num_layers_dec"] > 1 else "") +
            ("lm_prob_" + str(opts["lm_prob"]) + "_") +
            "run_id_" + str(opts["run_id"]) +
            ("_avg_" if opts["avg"] else ""))


def add_parse_options(parser: argparse.ArgumentParser) -> None:
    """Register every reference CLI flag (same names/defaults; main.py:41-57)."""
    # Train (train.py:397-430)
    parser.add_argument("-lm_prob", default=0.0, type=float)
    parser.add_argument("-run_id", "--run_id", default=0, type=int)
    parser.add_argument("-data_dir", default="data/tfrecords", type=str)
    parser.add_argument("-lm_data_dir", default="data/tfrecords/lm", type=str)
    parser.add_argument("-vocab_dir", "--vocab_dir", default="data/vocab", type=str)
    parser.add_argument("-tb_dir", "--train_base_dir", default="models", type=str)
    parser.add_argument("-feat_len", "--feat_length", default=80, type=int)
    parser.add_argument("-steps_per_checkpoint", default=500, type=int)
    parser.add_argument("-min_steps", "--min_steps", default=25000, type=int)
    parser.add_argument("-max_epochs", default=30, type=int)
    parser.add_argument("-pretrain_lm_path", default="", type=str)
    parser.add_argument("-pretrain_phone_path", default="", type=str)
    parser.add_argument("-pretrain_enc_path", default="", type=str,
                        help="SSL-pretrained encoder checkpoint "
                             "(train/ssl.py) partially restored into this "
                             "supervised run at init (extension)")
    parser.add_argument("-ssl", default=False, action="store_true",
                        help="BEST-RQ-style self-supervised encoder "
                             "pretraining on the corpus's features; targets "
                             "come from a frozen random-projection "
                             "quantizer, no transcripts are read "
                             "(extension; train/ssl.py)")
    parser.add_argument("-ssl_codebook_size", default=256, type=int)
    parser.add_argument("-ssl_codebook_dim", default=16, type=int)
    parser.add_argument("-ssl_mask_prob", default=0.06, type=float)
    parser.add_argument("-ssl_mask_span", default=5, type=int)
    parser.add_argument("-ssl_steps", default=0, type=int,
                        help="stop SSL pretraining after this many updates "
                             "(0 = run to -max_epochs)")
    parser.add_argument("-chaos", default=False, action="store_true")
    parser.add_argument("-subset_file", default="", type=str)
    parser.add_argument("-compile_cache", default="", type=str,
                        help="persistent compilation-cache directory of the "
                             "JAX package (not ported: raises)")
    # Encoder (encoder.py:182-200)
    parser.add_argument("-out_prob", "--out_prob", default=0.9, type=float)
    parser.add_argument("-use_lstm", "--use_lstm", default=True,
                        action="store_true")
    parser.add_argument("-gru", "--gru", default=False, action="store_true",
                        help="Use GRU cells (extension: the reference's "
                        "-use_lstm is store_true with default True, so its "
                        "CLI can never actually select GRU)")
    parser.add_argument("-hsize", "--hidden_size", default=256, type=int)
    parser.add_argument("-skip_step", "--skip_step", default=2, type=int)
    parser.add_argument("-init_res_fac", "--initial_res_fac", default=1, type=int)
    parser.add_argument("-stack_cons", default=1, type=int)
    parser.add_argument("-max_scaling_down", default=8, type=int)
    # Transformer encoder family (extension; models/transformer_encoder.py)
    parser.add_argument("-encoder_type", "--encoder_type", default="rnn",
                        type=str, choices=["rnn", "transformer"])
    parser.add_argument("-ctc_weight", "--ctc_weight", default=0.0,
                        type=float,
                        help="hybrid CTC/attention training weight "
                             "(extension; 0 = pure attention, reference)")
    parser.add_argument("-model_family", "--model_family", default="attention",
                        type=str, choices=["attention", "ctc", "transducer"],
                        help="extension: 'ctc' trains the encoder-only CTC "
                             "recognizer (models/ctc.py); 'transducer' the "
                             "RNN-T family (models/transducer.py, streaming-"
                             "native). Eval: CTC best-path/prefix beam, "
                             "transducer greedy/prefix beam")
    parser.add_argument("-joint_dim", "--joint_dim", default=256, type=int,
                        help="transducer joint network width")
    parser.add_argument("-num_heads", "--num_heads", default=4, type=int)
    parser.add_argument("-ffn_mult", "--ffn_mult", default=4, type=int)
    parser.add_argument("-enc_subsample", "--subsample", default=8, type=int)
    parser.add_argument("-rel_pos_bias", "--rel_pos_bias", default=False,
                        action="store_true")
    parser.add_argument("-conv_kernel", "--conv_kernel", default=0, type=int)
    parser.add_argument("-attn_chunk", "--attn_chunk", default=0, type=int,
                        help="Chunk-causal attention for the transformer "
                        "encoder: post-subsample frames per chunk (0 = full "
                        "attention). Trains a streamable encoder — the conv "
                        "module turns causal and inference can stream "
                        "EXACTLY with carried K/V caches")
    parser.add_argument("-attn_left", "--attn_left", default=8, type=int,
                        help="Chunk-causal left context, in chunks (with "
                        "-attn_chunk; bounds the streaming K/V cache)")
    parser.add_argument("-moe_experts", "--moe_experts", default=0, type=int,
                        help="Switch-style MoE FFN experts per transformer "
                             "block (0 = dense FFN); top-1 routing with "
                             "capacity + load-balance aux loss")
    parser.add_argument("-moe_capacity", "--moe_capacity", default=1.25,
                        type=float)
    parser.add_argument("-moe_aux_weight", "--moe_aux_weight", default=0.01,
                        type=float)
    parser.add_argument("-ep_shards", default=1, type=int,
                        help="Expert-parallel shards: MoE experts sharded "
                             "over an \"expert\" mesh axis (must divide "
                             "-moe_experts); composes with -pp_stages / "
                             "-sp_shards via a 2-D (stage|seq, expert) "
                             "mesh; 1 disables")
    # Decoder (decoder.py:182-193, attn_decoder.py:174-186)
    parser.add_argument("-hsize_dec", "--hidden_size_dec", default=256, type=int)
    parser.add_argument("-emb_size", "--emb_size", default=256, type=int)
    parser.add_argument("-num_layers_dec", "--num_layers_dec", default=1, type=int)
    parser.add_argument("-out_prob_dec", "--out_prob_dec", default=0.9, type=float)
    parser.add_argument("-samp_prob", "--samp_prob", default=0.1, type=float)
    parser.add_argument("-attn_vec_size", "--attention_vec_size", default=128, type=int)
    parser.add_argument("-lm_hsize", "--lm_hidden_size", default=256, type=int)
    parser.add_argument("-ind_softmax", "--ind_softmax", default=False,
                        action="store_true")
    parser.add_argument("-decoder_type", "--decoder_type", default="rnn",
                        type=str, choices=["rnn", "transformer"],
                        help="extension: 'transformer' swaps the recurrent "
                             "attention decoder for a pre-LN transformer "
                             "decoder (models/transformer_decoder.py) — "
                             "teacher forcing is one parallel pass, decode "
                             "carries KV caches in the beam state; "
                             "d_model=-hsize_dec, blocks=-num_layers_dec")
    parser.add_argument("-dec_heads", "--dec_heads", default=4, type=int,
                        help="transformer decoder attention heads")
    parser.add_argument("-dec_ffn_mult", "--dec_ffn_mult", default=4,
                        type=int, help="transformer decoder FFN multiple")
    # Seq2seq (seq2seq_model.py:199-216)
    parser.add_argument("-tasks", "--tasks", default="", type=str)
    parser.add_argument("-nlc", "--num_layers_char", default=4, type=int)
    parser.add_argument("-nlp", "--num_layers_phone", default=3, type=int)
    parser.add_argument("-max_out_char", "--max_output_char", default=120, type=int)
    parser.add_argument("-max_out_phone", "--max_output_phone", default=250, type=int)
    parser.add_argument("-lr_decay", "--learning_rate_decay_factor", default=0.5,
                        type=float)
    parser.add_argument("-lr_warmup", "--lr_warmup_steps", default=0, type=int,
                        help="linear LR warmup steps (extension; the "
                             "transformer family's standard ramp — 0 = "
                             "reference behavior)")
    parser.add_argument("-avg", "--avg", default=False, action="store_true")
    # LM (lm_model.py:118-121)
    parser.add_argument("-lm_learning_rate", default=1e-4, type=float)
    # Beam search (beam_search.py:340-350)
    parser.add_argument("-beam_size", default=1, type=int)
    parser.add_argument("-lm_weight", default=0.0, type=float)
    parser.add_argument("-lm_path", default="", type=str)
    parser.add_argument("-cov_penalty", default=0.0, type=float)
    parser.add_argument("-apply_cov_penalty", default=False,
                        action="store_true",
                        help="Actually apply cov_penalty (the reference "
                        "parses it but never applies it)")
    parser.add_argument("-word_ins_penalty", default=0.0, type=float)
    parser.add_argument("-ctc_rescore", "--ctc_rescore", default=0.0,
                        type=float,
                        help="extension: rescore the attention beam n-best "
                             "with the hybrid checkpoint's CTC head, weight "
                             "w in (1-w)*attention + w*ctc")
    parser.add_argument("-lm_rescore", "--lm_rescore", default=0.0,
                        type=float,
                        help="extension: second-pass LM rescoring — re-rank "
                             "the beam's full final candidate set by "
                             "score + w*log p_LM(seq) (the LM from "
                             "-lm_path, or the decoder's own weight-tied "
                             "LM when -lm_path is empty); the first pass "
                             "stays LM-free, unlike per-step -lm_weight "
                             "fusion (pick one of the two)")
    parser.add_argument("-joint_ctc", "--joint_ctc", default=0.0, type=float,
                        help="extension: one-pass joint CTC/attention "
                             "decoding — every beam step ranks "
                             "(1-w)*attention + w*CTC-prefix-score "
                             "(+ lm_weight*LM); needs a hybrid checkpoint")
    parser.add_argument("-ctc_pre_beam", "--ctc_pre_beam", default=0,
                        type=int,
                        help="joint decoding: CTC-score only the attention "
                             "top-P tokens per step (0 = full vocabulary; "
                             "use with large BPE vocabularies)")
    parser.add_argument("-boost_phrases", "--boost_phrases", default="",
                        type=str,
                        help="extension: contextual biasing — file with one "
                             "boost phrase per line (names, commands, rare "
                             "terms); works with every model family's beam")
    parser.add_argument("-boost_weight", "--boost_weight", default=0.0,
                        type=float,
                        help="contextual-biasing bonus per matched token "
                             "(divergence gives partial bonuses back)")
    parser.add_argument("-ilm_weight", "--ilm_weight", default=0.0,
                        type=float,
                        help="extension: subtract w * the model's INTERNAL "
                             "LM estimate from beam scores during shallow "
                             "fusion (ILME: zero-context decoder recurrence "
                             "for the attention family; HAT-style zero-"
                             "encoder joint for the transducer family) — "
                             "pair with -lm_path/-lm_weight")
    parser.add_argument("-nbest", "--nbest", default=1, type=int,
                        help="extension: also write the top-N hypotheses "
                             "per utterance with scores (nbest_*.txt); "
                             "works with every family's beam")
    # Eval mode
    parser.add_argument("-dev", default=False, action="store_true")
    parser.add_argument("-test", default=False, action="store_true")
    # TPU-specific additions
    parser.add_argument("-compute_dtype", default="bfloat16", type=str,
                        choices=["bfloat16", "float32"])
    parser.add_argument("-buck_batch_sizes", default="128,128,64,64,32",
                        type=str, help="Per-bucket batch sizes (the reference "
                        "hardcodes these at train.py:44)")
    parser.add_argument("-profile_dir", default="", type=str,
                        help="profiler trace output directory (not "
                             "ported: raises)")
    parser.add_argument("-eval_avg_ckpts", "--eval_avg_ckpts", default=1,
                        type=int,
                        help="evaluate the arithmetic mean of the last N "
                             "train-dir checkpoints instead of best/latest "
                             "(extension; standard ASR inference trick)")
    parser.add_argument("-spec_augment", default=False, action="store_true",
                        help="Enable on-device SpecAugment feature masking")
    parser.add_argument("-async_ckpt", default=False, action="store_true",
                        help="Overlap checkpoint serialization/disk IO with "
                             "training (the step loop only pays the "
                             "device->host fetch)")
    parser.add_argument("-remat", default=False, action="store_true",
                        help="Rematerialize encoder layers/blocks in the "
                             "backward pass (jax.checkpoint): trades "
                             "recompute FLOPs for ~num_layers-fold less "
                             "encoder activation memory; numerics unchanged")
    parser.add_argument("-grad_accum", default=1, type=int,
                        help="Accumulate gradients over N micro-batches per "
                             "optimizer update (must divide every bucket's "
                             "batch size); cuts activation memory ~N-fold "
                             "for large models at unchanged update "
                             "semantics")
    parser.add_argument("-ema_decay", default=0.0, type=float,
                        help="Maintain Polyak/EMA shadow weights with this "
                             "decay (e.g. 0.999); 0 disables. Dev-WER "
                             "checkpoint selection evaluates the EMA "
                             "weights when enabled")
    parser.add_argument("-eval_ema", default=False, action="store_true",
                        help="Evaluate the EMA shadow weights from a "
                             "checkpoint trained with -ema_decay")
    parser.add_argument("-score_unit", default="word", type=str,
                        choices=["word", "char"],
                        help="eval metric unit: filler-filtered WORD errors "
                             "(reference behavior) or CHARACTER errors over "
                             "the same filtered text (CER)")
    parser.add_argument("-freeze", default="", type=str,
                        help="comma-separated parameter-path substrings to "
                             "freeze (zero gradient), e.g. 'encoder' for "
                             "decoder-only fine-tuning after -pretrain_*")
    parser.add_argument("-speed_perturb", default="", type=str,
                        help="'lo,hi' per-utterance tempo augmentation "
                             "(feature-level time stretch), e.g. 0.9,1.1")
    parser.add_argument("-distill_dir", default="", type=str,
                        help="knowledge distillation: the TEACHER run dir "
                             "(architecture from its parameters.txt, "
                             "weights from its best/latest checkpoint); "
                             "the student trains on (1-w)*CE + "
                             "w*T^2*KL(teacher||student)")
    parser.add_argument("-distill_weight", default=0.5, type=float)
    parser.add_argument("-distill_temp", default=2.0, type=float)
    parser.add_argument("-mwer", default=False, action="store_true",
                        help="Minimum-WER sequence fine-tuning: ASR steps "
                             "minimize expected filler-filtered word errors "
                             "over the model's own n-best (resume a CE "
                             "checkpoint; attention family)")
    parser.add_argument("-mwer_nbest", default=4, type=int,
                        help="n-best size for the MWER expectation")
    parser.add_argument("-mwer_ce", default=0.01, type=float,
                        help="cross-entropy anchor weight inside the MWER "
                             "objective (Prabhavalkar et al. 2018)")
    parser.add_argument("-lora_rank", default=0, type=int,
                        help="LoRA parameter-efficient fine-tuning: rank of "
                             "the trainable low-rank deltas attached to 2-D "
                             "kernel leaves; the base weights freeze. "
                             "Decode surfaces merge the deltas after "
                             "restore (core/lora.py). 0 disables")
    parser.add_argument("-lora_alpha", default=0.0, type=float,
                        help="LoRA delta scale alpha/rank; 0 = rank "
                             "(unit scale)")
    parser.add_argument("-lora_targets", default="", type=str,
                        help="comma-separated path substrings selecting "
                             "which kernels get adapters (e.g. "
                             "'decoder_char'); empty = all 2-D kernels")
    parser.add_argument("-pp_stages", default=1, type=int,
                        help="Pipeline-parallel stages for the transformer "
                             "encoder's block stack (blocks sharded over a "
                             "stage mesh axis, microbatches flow via "
                             "ppermute); 1 disables. Composes with "
                             "-data_axis and -ep_shards (up to a 3-D "
                             "(data, stage, expert) mesh); mutually "
                             "exclusive with -sp_shards and -model_axis")
    parser.add_argument("-pp_micro", default=2, type=int,
                        help="Microbatches per pipeline-parallel step "
                             "(must divide every bucket batch size)")
    parser.add_argument("-sp_shards", default=1, type=int,
                        help="Sequence-parallel time shards for the "
                             "transformer blocks (activations sharded over "
                             "T, one K/V all-gather per block); 1 disables. "
                             "Composes with -data_axis and -ep_shards (up "
                             "to a 3-D (data, seq, expert) mesh); mutually "
                             "exclusive with -pp_stages and -model_axis")
    parser.add_argument("-quantize", default="", choices=["", "int8"],
                        help="Weight-only quantization for eval/serving: "
                             "int8 per-output-channel symmetric "
                             "(core/quant.py); dequant runs inside the "
                             "jitted decode")
    parser.add_argument("-data_axis", default=-1, type=int,
                        help="Mesh data-parallel axis size (-1: derive from "
                        "device count and bucket batch sizes)")
    parser.add_argument("-model_axis", default=1, type=int,
                        help="Mesh model axis size: shards the vocab-sized "
                        "projections/embeddings (core/sharding.py)")
    parser.add_argument("-fsdp", default=False, action="store_true",
                        help="ZeRO-3 fully-sharded data parallelism: shard "
                        "every large parameter leaf and its Adam moments "
                        "over the data axis; XLA all-gathers on use and "
                        "reduce-scatters gradients (core/sharding.py)")
    parser.add_argument("-skip_nonfinite", default=False,
                        action="store_true",
                        help="Skip updates whose loss/grads are non-finite "
                        "entirely on device (divergence protection; the "
                        "poisoned step costs nothing but itself)")
    parser.add_argument("-nan_recover", default=0, type=int,
                        help="On a non-finite cadence loss: restore the "
                        "latest checkpoint and halve the LR up to N times "
                        "before stopping (0 = stop immediately)")
    parser.add_argument("-platform", default="", type=str,
                        help="Device of the run: empty, 'gpu' or 'cuda' = "
                        "the CUDA card (raises without one); 'cpu' = the "
                        "CPU, through the kernels' plain versions")
    parser.add_argument("-dist_coordinator", default="", type=str,
                        help="host:port of process 0 for multi-host "
                        "training (not ported: raises)")
    parser.add_argument("-dist_nprocs", default=1, type=int)
    parser.add_argument("-dist_pid", default=0, type=int)
    parser.add_argument("-label_smoothing", default=0.0, type=float,
                        help="Label smoothing for the attention CE (extension)")


def parse_tasks(task_string: str) -> list[str]:
    tasks = ["char"]
    if "p" in task_string:
        tasks.append("phone")
    return tasks


def process_args(options: dict[str, Any],
                 vocab_sizes: dict[str, int] | None = None) -> ExperimentConfig:
    """Build the nested config tree from flat CLI options (main.py:60-164).

    vocab_sizes: per-task vocab size; when None, sizes stay at defaults (the
    CLI loads them from the vocab files).
    """
    options = dict(options)
    options["tasks"] = parse_tasks(options.get("tasks", ""))
    if options.get("gru"):
        options["use_lstm"] = False    # flows into encoder/decoder configs
                                       # and the run-dir name (no "lstm_")
    family = options.get("model_family", "attention")
    if family == "ctc":
        if options.get("lm_prob", 0.0) > 0:
            raise ValueError(
                "-model_family ctc has no attention decoder, so the "
                "weight-tied LM task cannot attach: use -lm_prob 0")
        if options.get("ctc_weight", 0.0) > 0:
            raise ValueError(
                "-ctc_weight is the HYBRID family's knob; -model_family ctc "
                "is already pure CTC")
    if family == "transducer":
        if options.get("lm_prob", 0.0) > 0:
            raise ValueError(
                "-model_family transducer has no attention decoder, so the "
                "weight-tied LM task cannot attach: use -lm_prob 0")
        if options.get("ctc_weight", 0.0) > 0:
            raise ValueError(
                "-ctc_weight is the HYBRID family's knob; the transducer "
                "family has its own alignment-free objective")

    if options.get("decoder_type", "rnn") == "transformer":
        if family != "attention":
            raise ValueError("-decoder_type transformer is the ATTENTION "
                             "family's decoder; the ctc/transducer families "
                             "have their own decoders")
        # The weight-tied LM task spans this decoder too: -lm_prob trains
        # the decoder's self-attention stack + embedding/softmax through a
        # causal LM head with cross-attention dropped
        # (transformer_decoder.apply_lm), mirroring the reference's
        # LM/decoder parameter sharing (lm_model.py:94-106);
        # -pretrain_lm_path partial-restores by pytree path as usual.
    if options.get("attn_chunk", 0) > 0:
        if options.get("encoder_type", "rnn") != "transformer":
            raise ValueError("-attn_chunk is the transformer encoder's "
                             "chunk-causal attention knob; the recurrent "
                             "pyramid streams exactly already when "
                             "forward-only (-bi_dir false)")
        if options.get("attn_left", 8) < 1:
            raise ValueError("-attn_left must be >= 1 (chunks of left "
                             "context bound the streaming K/V cache)")
    if options.get("distill_dir"):
        if family != "attention" or options.get("ctc_weight", 0.0) > 0:
            raise ValueError("-distill_dir currently covers the attention "
                             "family (teacher-forced char logits)")
        if options.get("mwer"):
            raise ValueError("-distill_dir and -mwer are different "
                             "objectives; run them as separate phases")
    if options.get("mwer"):
        if (family not in ("attention", "transducer")
                or options.get("ctc_weight", 0.0) > 0):
            raise ValueError("-mwer covers the attention and transducer "
                             "families (pure CE/NLL objectives)")
        if options.get("grad_accum", 1) > 1:
            raise ValueError("-mwer and -grad_accum are not combined "
                             "(the MWER step scores an n-best per batch)")
        if options.get("ema_decay", 0.0) > 0:
            raise ValueError("-mwer fine-tuning does not update EMA "
                             "shadows; drop -ema_decay for this phase")
        if options.get("spec_augment") or options.get("speed_perturb"):
            raise ValueError("-mwer scores the n-best on CLEAN features; "
                             "augmentation belongs to the CE phase")
    if options.get("lora_rank", 0):
        if options.get("lora_rank", 0) < 0:
            raise ValueError("-lora_rank must be >= 1 (0 disables)")
        if options.get("mwer"):
            raise ValueError("-mwer has its own stepper that does not "
                             "apply LoRA adapters; merge the LoRA run "
                             "first, then MWER-tune the merged weights")
        if options.get("ssl"):
            raise ValueError("-ssl pretrains the base encoder; LoRA "
                             "belongs to the supervised fine-tune phase")
    if options.get("ssl"):
        # SSL pretraining trains the ENCODER only on unlabeled features —
        # no decoder, no LM task, no sequence-level objectives.
        for bad, why in (("lm_prob", options.get("lm_prob", 0.0) > 0),
                         ("mwer", options.get("mwer")),
                         ("distill_dir", options.get("distill_dir")),
                         ("ctc_weight", options.get("ctc_weight", 0.0) > 0)):
            if why:
                raise ValueError(f"-ssl is encoder-only pretraining; -{bad} "
                                 "belongs to the supervised phase")
        if (options.get("pp_stages", 1) > 1 or options.get("sp_shards", 1) > 1
                or options.get("ep_shards", 1) > 1
                or options.get("fsdp")):
            raise ValueError("-ssl currently runs data-parallel only "
                             "(-data_axis); pp/sp/ep/fsdp cover the "
                             "supervised phase")
        if options.get("ema_decay", 0.0) > 0:
            raise ValueError("-ssl has no EMA shadows; the supervised "
                             "fine-tune phase owns -ema_decay")

    run_dir = get_run_dir_name(options)
    train_dir = os.path.join(options["train_base_dir"], run_dir)
    best_model_dir = os.path.join(options["train_base_dir"], "best_models", run_dir)

    num_layers = {t: options[f"num_layers_{t}"] for t in options["tasks"]}
    max_output = {t: options[f"max_output_{t}"] for t in options["tasks"]}

    encoder = _from_options(EncoderConfig, options)
    decoders: dict[str, DecoderConfig] = {}
    for task in options["tasks"]:
        dec = _from_options(DecoderConfig, options)
        dec.max_output = max_output[task]
        if vocab_sizes and task in vocab_sizes:
            dec.vocab_size = vocab_sizes[task]
        if task != "char":
            # Only the char decoder can be deep (main.py:127-131).
            dec.num_layers_dec = 1
        decoders[task] = dec

    model = _from_options(Seq2SeqConfig, options)
    model.tasks = options["tasks"]
    model.num_layers = num_layers
    model.max_output = max_output
    model.encoder = encoder
    model.decoders = decoders
    model.feat_length = options.get("feat_length", 80)

    train = _from_options(TrainConfig, options)
    train.train_dir = train_dir
    train.best_model_dir = best_model_dir
    if options.get("buck_batch_sizes"):
        train.buck_batch_size = [int(x) for x in
                                 str(options["buck_batch_sizes"]).split(",")]
        train.num_buckets = len(train.buck_batch_size)
        train.batch_size = train.buck_batch_size[0]

    lm = _from_options(LMConfig, options)
    if vocab_sizes and "char" in vocab_sizes:
        lm.vocab_size = vocab_sizes["char"]

    beam = _from_options(BeamConfig, options)
    return ExperimentConfig(model=model, train=train, lm=lm, beam=beam,
                            dev=options.get("dev", False),
                            test=options.get("test", False))


def _from_options(cls, options: dict[str, Any]):
    """Build a dataclass from flat options, with the reference's type-equality
    override guard (base_params.py:22-28)."""
    cfg = cls()
    for f in dataclasses.fields(cls):
        if f.name in options and options[f.name] is not None:
            default = getattr(cfg, f.name)
            if type(default) is type(options[f.name]):
                setattr(cfg, f.name, options[f.name])
    return cfg


def config_to_text(cfg: Any, indent: int = 0) -> str:
    """Sorted flat dump for parameters.txt (main.py:146-155)."""
    lines = []
    for f in sorted(dataclasses.fields(cfg), key=lambda f: f.name):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            lines.append(" " * indent + f.name + ":")
            lines.append(config_to_text(v, indent + 2))
        elif isinstance(v, dict) and v and dataclasses.is_dataclass(
                next(iter(v.values()))):
            for k, sub in sorted(v.items()):
                lines.append(" " * indent + f"{f.name}[{k}]:")
                lines.append(config_to_text(sub, indent + 2))
        else:
            lines.append(" " * indent + f"{f.name}\t{v}")
    return "\n".join(lines)


def config_from_text(text: str) -> ExperimentConfig:
    """Parse a parameters.txt dump back into the config tree (the inverse
    of config_to_text). Unknown keys — fields from other framework
    versions — are dropped; missing keys keep their dataclass defaults.
    Used to reload a RUN's exact architecture from its own run dir (e.g.
    the distillation teacher)."""
    import ast

    lines = [ln for ln in text.splitlines() if ln.strip()]

    def parse_block(idx: int, indent: int):
        out: dict[str, Any] = {}
        while idx < len(lines):
            line = lines[idx]
            cur = len(line) - len(line.lstrip())
            if cur < indent:
                break
            body = line.strip()
            if body.endswith(":") and "\t" not in body:
                name = body[:-1]
                sub, idx = parse_block(idx + 1, cur + 1)
                if name.endswith("]"):               # decoders[char]:
                    base, _, key = name[:-1].partition("[")
                    out.setdefault(base, {})[key] = sub
                else:
                    out[name] = sub
            else:
                k, _, v = body.partition("\t")
                try:
                    out[k] = ast.literal_eval(v)
                except (ValueError, SyntaxError):
                    out[k] = v
                idx += 1
        return out, idx

    tree, _ = parse_block(0, 0)

    def build(cls, d: dict):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    m = dict(tree.get("model", {}))
    enc = build(EncoderConfig, m.pop("encoder", {}))
    decs = {k: build(DecoderConfig, v)
            for k, v in m.pop("decoders", {}).items()}
    names = {f.name for f in dataclasses.fields(Seq2SeqConfig)}
    model = Seq2SeqConfig(encoder=enc, decoders=decs,
                          **{k: v for k, v in m.items()
                             if k in names and k not in ("encoder",
                                                         "decoders")})
    return ExperimentConfig(
        model=model,
        train=build(TrainConfig, tree.get("train", {})),
        lm=build(LMConfig, tree.get("lm", {})),
        beam=build(BeamConfig, tree.get("beam", {})),
        dev=bool(tree.get("dev", False)),
        test=bool(tree.get("test", False)),
    )


def clone(cfg):
    return copy.deepcopy(cfg)
