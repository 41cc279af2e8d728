#!/usr/bin/env python3
"""Kernel #1's inference form (csrc/lstm_bidir.cu) under the plan its
source chooses and under other plans of the same walk, on one GPU.

    python3 tools/lstm_fwd_plans.py [--T 512] [--B 8] [--H 256]

At the serving shape by default (T=512, B=8, H=256; random inputs from
seed 0, lengths 40-T, float32). Each plan of PLANS (blocks a cluster, rows
a cluster) is launched through the C entry e2e_lstm_bidir_fwd, its h held
against lstm_seq_bidir_reference (atol 1e-4) and timed by CUDA events
(chip_smoke.time_ms, 20 calls), beside the wrapper on the source's own
choice (lstm_bidir.fwd_plan). Prints the card's name and power limit, then
one JSON object; exits 1 without a CUDA device or where a plan disagrees.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from e2e_asr_tpu_torch.kernels import build, lstm_bidir  # noqa: E402

# (blocks a cluster, rows a cluster) timed beside the source's choice.
PLANS = ((8, 4), (16, 4), (8, 8), (16, 8))
ATOL = 1e-4


def launch(args, T: int, B: int, H: int, cluster: int, rows: int):
    """One launch of the inference form on the given plan: (h_fw, h_bw)."""
    dev = args[0].device
    out = torch.empty(2, T, B, H, device=dev)
    err = build.library().e2e_lstm_bidir_fwd(
        *[a.data_ptr() for a in args], out[0].data_ptr(), out[1].data_ptr(),
        T, B, H, cluster, rows, build.stream_ptr(dev))
    build.check(err, f"lstm_seq_bidir on clusters of {cluster}, {rows} rows")
    return out.unbind(0)


def max_err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--T", type=int, default=512)
    parser.add_argument("--B", type=int, default=8)
    parser.add_argument("--H", type=int, default=256)
    a = parser.parse_args()
    if not torch.cuda.is_available():
        print("lstm_fwd_plans: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    T, B, H = a.T, a.B, a.H
    rng = np.random.default_rng(0)
    rand = lambda *s, scale=1.0: torch.tensor(  # noqa: E731
        rng.normal(size=s).astype(np.float32) * scale, device=dev)
    lens = torch.tensor(rng.integers(min(40, T), T + 1, size=B), device=dev)
    lens[0] = T
    mask = (torch.arange(T, device=dev)[:, None]
            >= T - lens[None, :]).float()[:, :, None]
    args = (rand(T, B, 4 * H), rand(T, B, 4 * H), rand(H, 4 * H, scale=0.1),
            rand(H, 4 * H, scale=0.1), mask)
    result = {"card": card, "T": T, "B": B, "H": H, "plans": []}
    with torch.no_grad():
        want = lstm_bidir.lstm_seq_bidir_reference(*args)
        chosen = lstm_bidir.fwd_plan(H, B, 0)
        err = max_err(lstm_bidir.lstm_seq_bidir(*args), want)
        ms = chip_smoke.time_ms(lambda: lstm_bidir.lstm_seq_bidir(*args), 20)
        result["chosen"] = {"cluster": chosen["cluster"], "rows": chosen["Rg"],
                            "route": chosen["route"], "max_abs_err": err,
                            "ms": ms, "us_per_step": ms * 1e3 / T}
        for cluster, rows in PLANS:
            err = max_err(launch(args, T, B, H, cluster, rows), want)
            ms = chip_smoke.time_ms(
                lambda c=cluster, r=rows: launch(args, T, B, H, c, r), 20)
            result["plans"].append({"cluster": cluster, "rows": rows,
                                    "max_abs_err": err, "ms": ms,
                                    "us_per_step": ms * 1e3 / T})
    print(json.dumps(result), flush=True)
    bad = [p for p in [result["chosen"], *result["plans"]]
           if not p["max_abs_err"] <= ATOL]
    if bad:
        print(f"lstm_fwd_plans: FAILED: beyond {ATOL}: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
