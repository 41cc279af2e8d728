"""Build the CUDA sources in `e2e_asr_tpu_torch/csrc/` into one shared
library with a plain C interface and load it with ctypes.

Each source compiles in its own `nvcc` process, all started together, and
the objects are linked into the library, so the build takes about as long
as the slowest source.

The library is compiled by `nvcc` for `sm_90a` at first use, into
`build/e2e_asr_tpu_torch/` at the repository root, under a name keyed by a
hash of the sources: an edited source never loads a stale build. Nothing is
compiled when a module is imported, so the CPU-only test suite imports every
module of the package without a CUDA toolkit. A failed build raises.

Every C entry point returns the `cudaError_t` of its launch; `check()` turns a
nonzero code into a RuntimeError with CUDA's message.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "e2e_asr_tpu_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> argtypes of every C entry point (restype is int: a cudaError_t).
_SIGNATURES = {
    "e2e_lstm_bidir_fwd": [_P] * 7 + [_I] * 5 + [_P],
    "e2e_lstm_bidir_fwd_train": [_P] * 9 + [_I] * 5 + [_P],
    "e2e_lstm_bidir_fwd_plan": [_I, _I, _P],
    "e2e_lstm_bwd": [_P, _I, _I, _I, _I, _I, _I, _I, _P],
    "e2e_lstm_bwd_plan": [_I, _I, _I, _P],
    "e2e_lstm_seq_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "e2e_lstm_wide_fwd": [_P] * 5 + [_I] * 5 + [_P, _P],
    "e2e_lstm_wide_fwd_plan": [_I, _P],
    "e2e_lstm_wide_bwd": [_P] * 10 + [_I] * 4 + [_P],
    "e2e_lstm_wide_bwd_plan": [_I, _P],
    "e2e_gru_fwd": [_P, _I, _I, _I, _I, _P],
    "e2e_gru_bwd": [_P, _I, _I, _I, _I, _I, _P],
    "e2e_dec_train_fwd": [_P, _I, _P, _P],
    "e2e_dec_train_bwd": [_P, _I, _P, _P],
    "e2e_dec_train_gru_fwd": [_P, _I, _P, _P],
    "e2e_dec_train_gru_bwd": [_P, _I, _P, _P],
    "e2e_cells_fused": [_P, _I, _P, _I, _P],
    "e2e_attn_output_fused": [_P, _I, _P, _I, _P],
    "e2e_output_fused": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "e2e_beam_select": [_P, _P, _P, _P, _I, _I, _I, _I,
                        _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "e2e_beam_mega_scratch": [_P, _I, _P],
    "e2e_beam_mega": [_P, _I, _P, _I, ctypes.c_double, _P],
    "e2e_transducer_fwd": [_P] * 6 + [_I, _I, _I, _P],
    "e2e_transducer_bwd": [_P] * 9 + [_I, _I, _I, _P],
    "e2e_ctc_prefix_scan": [_P] * 9 + [_I, _I, _I, _P],
    "e2e_mhsa_fwd": [_P] * 7 + [_I] * 5 + [_P],
    "e2e_mhsa_plan": [_I] * 4 + [_P],
}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libe2e_asr_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if this source hash has no build yet. The ptxas
    report (registers, shared memory, spills per kernel) is kept beside it
    as `<lib>.ptxas.txt`."""
    lib = library_path()
    with _lock:
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{lib.stem}.{os.getpid()}"
        nvcc = _nvcc()
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = BUILD_DIR / f"{tag}.{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        outs = [proc.communicate()[0] for _, _, proc in jobs]
        report = []
        for (cmd, _, proc), out in zip(jobs, outs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}")
            report.append(out)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp),
               *[str(obj) for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        for _, obj, _ in jobs:
            obj.unlink()
        Path(str(lib) + ".ptxas.txt").write_text("".join(report))
        os.replace(tmp, lib)
        return lib


def ptxas_report() -> str:
    return Path(str(build()) + ".ptxas.txt").read_text()


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.e2e_error_string.argtypes = [ctypes.c_int]
    lib.e2e_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = library().e2e_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def ptrs(*tensors) -> ctypes.Array:
    """A C array of device pointers (None -> NULL)."""
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


def ints(*values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


def check_width(H: int, limit: int, name: str) -> None:
    """Raise ValueError before a launch whose hidden width H is above the
    kernel's `limit` (one block a chain keeps a whole layer's units)."""
    if H > limit:
        raise ValueError(f"{name}: H={H} is above the kernel's limit of "
                         f"{limit} units; wider layers are not ported yet "
                         "(ROADMAP.md Queue 1, 'Wide layers')")


def require(t, name: str, dtype, shape: tuple, device) -> None:
    """Validate a tensor handed to a kernel: device, dtype, shape, layout."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
