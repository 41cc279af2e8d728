"""WER scoring: Levenshtein distance with insertion/deletion/substitution
breakdown (a copy of e2e_asr_tpu/eval/score.py).

Distance(hyp -> ref) plus opcode counts, as the reference's
`edit_distance.SequenceMatcher` use (eval_model.py:206-241). The reported
metric is the filler-filtered WER total_errors / total_gold_words
(eval_model.py:97-111).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class EditStats:
    distance: int = 0
    insertions: int = 0   # words present in ref but missing from hyp path
    deletions: int = 0    # words in hyp that must be removed
    substitutions: int = 0

    def __iadd__(self, other: "EditStats"):
        self.distance += other.distance
        self.insertions += other.insertions
        self.deletions += other.deletions
        self.substitutions += other.substitutions
        return self


def edit_distance(hyp: list[str], ref: list[str]) -> EditStats:
    """Levenshtein ops turning `hyp` into `ref` (the reference's direction,
    eval_model.py:218: "Turn decoded_words into gold_words")."""
    n, m = len(hyp), len(ref)
    # DP over costs, then backtrace for opcode counts.
    dist = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(1, n + 1):
        dist[i][0] = i
    for j in range(1, m + 1):
        dist[0][j] = j
    for i in range(1, n + 1):
        hi = hyp[i - 1]
        row, prev = dist[i], dist[i - 1]
        for j in range(1, m + 1):
            cost = 0 if hi == ref[j - 1] else 1
            row[j] = min(prev[j] + 1,        # delete hyp[i-1]
                         row[j - 1] + 1,     # insert ref[j-1]
                         prev[j - 1] + cost)  # match / substitute
    stats = EditStats(distance=dist[n][m])
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dist[i][j] == dist[i - 1][j - 1] + (
                0 if hyp[i - 1] == ref[j - 1] else 1):
            if hyp[i - 1] != ref[j - 1]:
                stats.substitutions += 1
            i, j = i - 1, j - 1
        elif i > 0 and dist[i][j] == dist[i - 1][j] + 1:
            stats.deletions += 1
            i -= 1
        else:
            stats.insertions += 1
            j -= 1
    return stats


@dataclass
class WerAccumulator:
    """Accumulates filler-filtered WER over a corpus."""
    total_errors: int = 0
    total_words: int = 0
    insertions: int = 0
    deletions: int = 0
    substitutions: int = 0
    sentences: int = 0

    def add(self, hyp_words: list[str], ref_words: list[str]) -> None:
        stats = edit_distance(hyp_words, ref_words)
        self.total_errors += stats.distance
        self.insertions += stats.insertions
        self.deletions += stats.deletions
        self.substitutions += stats.substitutions
        self.total_words += len(ref_words)
        self.sentences += 1

    @property
    def score(self) -> float:
        try:
            return float(self.total_errors) / float(self.total_words)
        except ZeroDivisionError:
            return 0.0


def accumulate(acc: "WerAccumulator", hyp_words: list[str],
               gold_words: list[str], unit: str = "word") -> None:
    """Add one utterance at the configured metric unit: "word" = the
    reference's filler-filtered WER; "char" = CER over the same filtered
    text (spaces count as symbols). One definition for every evaluator."""
    if unit == "char":
        acc.add(list(" ".join(hyp_words)), list(" ".join(gold_words)))
    else:
        acc.add(hyp_words, gold_words)

