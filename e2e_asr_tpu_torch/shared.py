"""What the port shares with the JAX package, in one place.

`e2e_asr_tpu.config` and `e2e_asr_tpu.data.text` import no JAX, so the port
uses their configuration dataclasses and vocabulary helpers as they are
instead of copying them. Every module of the port, and scripts that drive
it (chip_smoke.py), reach them through here, so this is the one import of
the JAX package's code and nothing else of it is loaded.
"""
from e2e_asr_tpu.config import (BeamConfig, DecoderConfig, EncoderConfig,
                                Seq2SeqConfig)
from e2e_asr_tpu.data.text import (EOS_ID, GO_ID, START_VOCAB,
                                   get_relevant_words, ids_to_sentence)

__all__ = ["BeamConfig", "DecoderConfig", "EncoderConfig", "Seq2SeqConfig",
           "EOS_ID", "GO_ID", "START_VOCAB", "get_relevant_words",
           "ids_to_sentence"]
