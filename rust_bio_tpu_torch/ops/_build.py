"""Build the CUDA sources in ``csrc/`` with nvcc and bind them with ctypes.

Each source is compiled on its own into ``_build/<name>-<hash>.so`` with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

and the source's ``EXTRA_FLAGS``, where ``<hash>`` covers the source and
the flags, so an edited source is rebuilt and an unchanged one is reused.
``build()`` starts one nvcc per missing library, all at once. Every C
entry point takes raw pointers, plain ints and the CUDA stream last, and
returns ``cudaGetLastError()`` after its launch; ``CudaKernel.launch``
raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
SOURCES = (
    "walk_sweep", "fm_search", "rle_merge", "fmd_smem",
    "sw_warp", "sw_global_rows", "walk_global_seg", "walk_steps",
    "sw_columns", "sw_banded", "pairhmm_scaled", "pairhmm_log", "pairhmm_exact",
    "pairhmm_homopoly", "hmm",
)
# per-source flags after NVCC_FLAGS: the PairHMM forwards keep every product
# and sum unfused, so they round as their plain versions and the host
# oracle; K17 also flushes f32 subnormals to zero, as the TPU does; the HMM
# scans' Gaussian density and sums round as their plain versions and XLA's
EXTRA_FLAGS = {
    "pairhmm_scaled": ("-fmad=false", "-ftz=true"),
    "pairhmm_log": ("-fmad=false",),
    "pairhmm_exact": ("-fmad=false",),
    "pairhmm_homopoly": ("-fmad=false",),
    "hmm": ("-fmad=false",),
}

PTR = ctypes.c_void_p
INT = ctypes.c_int
I64 = ctypes.c_longlong

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in ([home] if home else []) + ["/usr/local/cuda"]:
        cand = Path(root) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _target(name: str) -> Path:
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + " ".join(_flags(name)).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source whose library is missing, one nvcc
    process per source, all started together. Raises on any failure."""
    targets = {name: _target(name) for name in names}
    running = []
    for name, target in targets.items():
        if target.exists():
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        running.append((name, target, tmp, proc))
    errors: List[str] = []
    for name, target, tmp, proc in running:
        out, err = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{err}{out}")
        else:
            os.replace(tmp, target)  # atomic: concurrent builds agree
    if errors:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(errors))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        lib.rbt_error_string.argtypes = [INT]
        lib.rbt_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


class CudaKernel:
    """One C entry point of a ``csrc/`` source, with its launch count.

    ``argtypes`` lists the entry point's arguments before the stream, which
    is always passed last. ``launches`` goes up by one per successful launch
    and nowhere else."""

    def __init__(self, source: str, symbol: str, argtypes: List) -> None:
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def launch(self, device: torch.device, *args) -> None:
        if self._fn is None:
            fn = getattr(library(self.source), self.symbol)
            fn.argtypes = self.argtypes + [PTR]
            fn.restype = INT
            self._fn = fn
        with torch.cuda.device(device):
            rc = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            msg = library(self.source).rbt_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {rc}: {msg}")
        self.launches += 1


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    """Raise unless ``t`` has this dtype and shape and is contiguous."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_lengths(lens: torch.Tensor, name: str, limit: int) -> None:
    """Raise unless every entry of ``lens`` lies in [0, limit] (one sync):
    the kernels index their inputs with these lengths."""
    if lens.numel() and bool(((lens < 0) | (lens > limit)).any()):
        raise ValueError(f"{name}: entries must lie in [0, {limit}]")


def same_device(*ts: torch.Tensor) -> torch.device:
    """The one device of ``ts``; raises when they differ or it is neither
    the CPU nor CUDA."""
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev
