"""Vocabulary constants and the text helpers the port needs: a copy of the
corresponding part of e2e_asr_tpu/data/text.py (special symbols, the filler
filter used before WER scoring, ids -> sentence)."""
from __future__ import annotations

import re

PAD = "<pad>"
GO = "<go>"
EOS = "<eos>"
START_VOCAB = [PAD, GO, EOS]

PAD_ID = 0
GO_ID = 1
EOS_ID = 2

# Fillers / hesitations removed before WER scoring.
IGNORED_WORDS = ["[noise]", "[laughter]", "[vocalized-noise]", "uh", "um",
                 "eh", "mm", "hm", "ah", "huh", "ha", "er", "oof", "hee",
                 "ach", "eee", "ew"]

_SWBD_MAP = {"!": "[laughter]", "@": "[noise]", "#": "[vocalized-noise]"}
_SWBD_RE = re.compile("(%s)" % "|".join(map(re.escape, _SWBD_MAP)))


def reverse_swbd_normalize(text: str) -> str:
    """Expand the compact char-vocab symbols back for scoring."""
    return _SWBD_RE.sub(lambda m: _SWBD_MAP[m.group(0)], text)


def get_relevant_words(char_str: str) -> tuple[list[str], list[str]]:
    """(all words, filler/partial-filtered words)."""
    char_str = char_str.replace("<sp>", " ")
    words = char_str.split()
    rel = [w for w in words
           if w not in IGNORED_WORDS and not (len(w) > 0 and w[-1] == "-")]
    return words, rel


def ids_to_sentence(id_seq, rev_vocab: list[str]) -> str:
    """Token ids -> sentence: truncate at the first <eos> and then at the
    first <pad>, join, '▁' -> space, expand the SWBD symbols."""
    ids = [int(i) for i in id_seq]
    if EOS_ID in ids:
        ids = ids[: ids.index(EOS_ID)]
    if PAD_ID in ids:
        ids = ids[: ids.index(PAD_ID)]
    pieces = [rev_vocab[i] if 0 <= i < len(rev_vocab) else "" for i in ids]
    sent = "".join(pieces).replace("▁", " ").strip()
    return reverse_swbd_normalize(sent)
