"""Beam hyperparameter grid search, in-process and resumable (port of
e2e_asr_tpu/tools/beam_grid.py, which replaces the reference's
grid_search_for_beam.py).

Sweeps beam_size in {4, 8, 16} x cov_penalty in linspace(0.05, 0.25, 5)
over already-loaded params, each configuration's dev WER appended to
{out_dir}/perf.txt as it is measured (a rerun resumes from the file); with
`test_batches_fn`, the best dev configuration then runs on the test set
with full scoring artifacts in {out_dir}/final_eval and its numbers in
final_eval/score.txt. cov_penalty is a no-op in the reference's scorer and
here; it stays in the sweep for parity of artifacts. At a dev batch size
of 1 or 2 every beam size of the sweep takes kernel #15's route
(eval/beam.py).

Not ported (NotImplementedError naming the ROADMAP.md item): the
lm_weight dimension (`use_lm`, RNN-LM fusion) and non-zero `ilm_weights`.
"""
from __future__ import annotations

import os
from os import path

import numpy as np

from e2e_asr_tpu_torch.config import BeamConfig, Seq2SeqConfig
from e2e_asr_tpu_torch.eval.beam_eval import BeamEvaluator


def load_perf(perf_file: str) -> dict:
    perf = {}
    if path.isfile(perf_file):
        try:
            with open(perf_file) as f:
                for line in f:
                    fields = line.strip().split()
                    if len(fields) == 4:          # pre-ilm files: ilm = 0
                        (beam_size, cov, lmw), err = fields[:3], fields[3]
                        ilm = "0"
                    else:
                        (beam_size, cov, lmw, ilm), err = (fields[:4],
                                                           fields[4])
                    perf[(int(beam_size), round(float(cov), 4),
                          round(float(lmw), 4),
                          round(float(ilm), 4))] = float(err)
            print(f"Loaded {len(perf)} entries from grid search")
        except ValueError:
            perf = {}
    return perf


def grid_search(params, model_cfg: Seq2SeqConfig, rev_vocab, dev_batches_fn,
                out_dir: str, *, use_lm: bool = False, lm_params=None,
                compute_dtype=None,
                beam_sizes=(4, 8, 16),
                cov_penalties=None,
                lm_weights=None,
                ilm_weights=(0,),
                test_batches_fn=None,
                device=None) -> tuple[BeamConfig, float]:
    """dev_batches_fn: () -> iterable of dataset batches (fresh per config).

    Returns (best BeamConfig, best dev score). When `test_batches_fn` is
    given, the best dev config is then run on the test set with full
    scoring artifacts written to {out_dir}/final_eval. Decodes on `device`
    (default: the CUDA card)."""
    todo = "is not ported yet (ROADMAP.md Queue 1, 'Decode features')"
    if use_lm or lm_params is not None or any(lm_weights or ()):
        raise NotImplementedError(f"the LM-fusion sweep {todo}")
    if any(ilm_weights):
        raise NotImplementedError(f"internal-LM subtraction {todo}")
    if cov_penalties is None:
        cov_penalties = list(np.linspace(0.05, 0.25, num=5))
    lm_weights = [0]

    os.makedirs(out_dir, exist_ok=True)
    perf_file = path.join(out_dir, "perf.txt")
    perf = load_perf(perf_file)

    def evaluator(beam_cfg, where):
        return BeamEvaluator(model_cfg, beam_cfg, rev_vocab, where,
                             compute_dtype=compute_dtype, device=device)

    best_err, best_cfg = 1.0, BeamConfig(beam_size=1)
    with open(perf_file, "a") as perf_f:
        for beam_size in beam_sizes:
            print(f"\nBeam size: {beam_size}")
            for cov in cov_penalties:
                for ilm in ilm_weights:
                    for lmw in lm_weights:
                        key = (beam_size, round(float(cov), 4),
                               round(float(lmw), 4), round(float(ilm), 4))
                        if key in perf:
                            print("From previous exec: ", end="")
                            err = perf[key]
                        else:
                            beam_cfg = BeamConfig(beam_size=beam_size,
                                                  cov_penalty=float(cov),
                                                  lm_weight=float(lmw),
                                                  ilm_weight=float(ilm))
                            err = evaluator(beam_cfg, out_dir)(
                                params, dev_batches_fn(), write_files=False)
                            perf_f.write(f"{beam_size} {cov:.4f} {lmw:.4f} "
                                         f"{ilm:.4f} {err:f}\n")
                            perf_f.flush()
                            perf[key] = err
                        print(f"ASR Error: {err:.4f}, Beam size: {beam_size}, "
                              f"cov penalty: {cov:.2f} lm weight: {lmw:.2f}"
                              + (f" ilm weight: {ilm:.2f}"
                                 if len(ilm_weights) > 1 else ""))
                        if err > best_err + 0.05:
                            print("Not exploring further increasing lm_weight")
                            break
                        if best_err > err:
                            print("Best config updated!!")
                            best_err = err
                            best_cfg = BeamConfig(beam_size=beam_size,
                                                  cov_penalty=float(cov),
                                                  lm_weight=float(lmw),
                                                  ilm_weight=float(ilm))

    if test_batches_fn is not None:
        final_dir = path.join(out_dir, "final_eval")
        os.makedirs(final_dir, exist_ok=True)
        test_err = evaluator(best_cfg, final_dir)(params, test_batches_fn(),
                                                  write_files=True)
        print(f"Final test ASR Error: {test_err:.4f} "
              f"(beam {best_cfg.beam_size}, lm_weight {best_cfg.lm_weight})")
        with open(path.join(final_dir, "score.txt"), "w") as f:
            f.write(f"beam_size {best_cfg.beam_size} "
                    f"cov_penalty {best_cfg.cov_penalty:.4f} "
                    f"lm_weight {best_cfg.lm_weight:.4f} "
                    f"ilm_weight {best_cfg.ilm_weight:.4f} "
                    f"dev_err {best_err:f} test_err {test_err:f}\n")
    return best_cfg, best_err
