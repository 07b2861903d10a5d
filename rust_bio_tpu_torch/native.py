"""ctypes bindings of the port's host C++: the band builder of the banded
aligner (``csrc/band_build.cpp``, port of the band entry points of
``rust_bio_tpu.native``), and the SA-IS suffix arrays and the column-RLE
CIGAR emitter (``csrc/host_index.cpp`` over ``csrc/sais.hpp``, port of
``rust_bio_tpu.native.sais``, ``sais_u32`` and ``cigars_colrle``).

Both sources are compiled together at first use with

    c++ -O3 -std=c++17 -shared -fPIC -pthread

into ``ops/_build/band_build-<hash>.so``, ``<hash>`` covering the sources,
the header and the flags. A failed build raises ``RuntimeError`` with the
compiler's message: there is no Python stand-in (the Python builders in
``sparse`` and ``banded.Band``, the prefix-doubling suffix array and the
numpy CIGAR merge are the oracles the tests hold this library against).
Every foreign call releases the GIL (ctypes does), so a band build on one
thread overlaps device work queued from another.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "band_build.cpp"
# compiled into the same library: the SAIS entry points and the CIGAR
# emitter, and the header they include
EXTRA_SOURCES = (SOURCE.parent / "host_index.cpp",)
HEADERS = (SOURCE.parent / "sais.hpp",)
BUILD_DIR = Path(__file__).resolve().parent / "ops" / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None

I64 = ctypes.c_int64
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u16p = ctypes.POINTER(ctypes.c_uint16)
_u32p = ctypes.POINTER(ctypes.c_uint32)


def _compiler() -> str:
    for name in (os.environ.get("CXX"), "c++", "g++"):
        if name and shutil.which(name):
            return shutil.which(name)
    raise RuntimeError("no C++ compiler found (c++ or g++ on PATH, or set CXX)")


def library_path() -> Path:
    """The built library, compiled now if it is missing."""
    files = (SOURCE, *EXTRA_SOURCES, *HEADERS)
    digest = hashlib.sha256(b"".join(f.read_bytes() for f in files) + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    target = BUILD_DIR / f"band_build-{digest}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *(str(f) for f in EXTRA_SOURCES)], capture_output=True, text=True
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed (exit {proc.returncode}):\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, target)  # atomic: concurrent builds agree
    return target


def get_lib() -> ctypes.CDLL:
    """The loaded library (built at first use); raises when it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(library_path()))
            lib.sdpkpp_i64.argtypes = [_i64p, _i64p, I64, I64, I64, I64, I64, _i64p, _i64p, _i64p]
            lib.sdpkpp_i64.restype = None
            lib.kmer_matches_i64.argtypes = [_u8p, I64, _u8p, I64, I64, _i64p, I64]
            lib.kmer_matches_i64.restype = I64
            lib.band_raster_i64.argtypes = [_i64p] + [I64] * 9 + [_i32p, _i32p]
            lib.band_raster_i64.restype = None
            lib.band_build_batch.argtypes = (
                [_u8p, _i64p, I64, _u8p, _i64p] + [I64] * 14 + [_i32p, _i32p, _i64p, _i64p, _i64p, _i64p]
            )
            lib.band_build_batch.restype = None
            lib.sais_i64.argtypes = [_i64p, I64, I64, _i64p]
            lib.sais_i64.restype = None
            lib.sais_u8_i32.argtypes = [_u8p, ctypes.c_int32, ctypes.c_int32, _i32p]
            lib.sais_u8_i32.restype = None
            lib.sais_u8_i64.argtypes = [_u8p, I64, I64, _i64p]
            lib.sais_u8_i64.restype = None
            lib.sais_u8_u32.argtypes = [_u8p, I64, I64, _u32p]
            lib.sais_u8_u32.restype = None
            lib.cigars_colrle.argtypes = [_u16p, _u16p, I64, I64] + [_i32p] * 7 + [I64, ctypes.c_char_p, _i32p, I64]
            lib.cigars_colrle.restype = None
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(typ)


def kmer_matches(x: bytes, y: bytes, k: int) -> np.ndarray:
    """Sorted (i, j) k-mer match pairs of x against y, (n, 2) int64
    (``sparse.find_kmer_matches``'s list as an array)."""
    lib = get_lib()
    xa = np.frombuffer(x, dtype=np.uint8)
    ya = np.frombuffer(y, dtype=np.uint8)
    cap = max(len(x) + len(y), 64)
    while True:
        out = np.empty(2 * cap, dtype=np.int64)
        cnt = int(lib.kmer_matches_i64(_ptr(xa, _u8p), len(x), _ptr(ya, _u8p), len(y), int(k), _ptr(out, _i64p), cap))
        if cnt <= cap:
            return out[: 2 * cnt].reshape(cnt, 2)
        cap = cnt


def sdpkpp_native(xs, ys, k: int, match_score: int, go_neg: int, ge_neg: int):
    """sdpkpp chaining of sorted matches (``go_neg``/``ge_neg`` the positive
    gap penalties): (dp_score, dp_prev (nm,) int64, best_score, best_idx)."""
    lib = get_lib()
    xs = np.ascontiguousarray(xs, dtype=np.int64)
    ys = np.ascontiguousarray(ys, dtype=np.int64)
    nm = len(xs)
    dp_score = np.zeros(nm, dtype=np.int64)
    dp_prev = np.zeros(nm, dtype=np.int64)
    best = np.zeros(2, dtype=np.int64)
    lib.sdpkpp_i64(
        _ptr(xs, _i64p), _ptr(ys, _i64p), nm, int(k), int(match_score), int(go_neg), int(ge_neg),
        _ptr(dp_score, _i64p), _ptr(dp_prev, _i64p), _ptr(best, _i64p),
    )
    return dp_score, dp_prev, int(best[0]), int(best[1])


def band_raster(path_xy: np.ndarray, m: int, n: int, k: int, w: int, clips):
    """Per-column band (starts, ends), each (n + 1,) int32, from a sdpkpp
    match path ((np, 2) int64 in path order; ``clips`` (xcp, xcs, ycp,
    ycs)): ``banded.Band.create_from_match_path``'s rows."""
    lib = get_lib()
    p = np.ascontiguousarray(path_xy, dtype=np.int64)
    starts = np.empty(n + 1, dtype=np.int32)
    ends = np.empty(n + 1, dtype=np.int32)
    lib.band_raster_i64(
        _ptr(p, _i64p), len(p), int(m), int(n), int(k), int(w), *(int(c) for c in clips),
        _ptr(starts, _i32p), _ptr(ends, _i32p),
    )
    return starts, ends


def band_build_batch(xb, mlens, yb, nlens, k: int, w: int, clips, match_score: int, go_neg: int, ge_neg: int,
                     crop: bool, wcap: int, nthreads: int = 0):
    """Every pair's band in one threaded call, as cropped column windows.

    ``xb``/``yb`` (B, Mmax)/(B, Nmax) uint8 rows zero-padded past
    ``mlens``/``nlens``; ``clips`` (xcp, xcs, ycp, ycs). Returns (st_w, en_w
    (B, wcap + 1) int32: the band rows of columns [c0, c0 + nle], padded
    with (m + 1, 0); c0, nle (B,) int64: the window's first column and
    length, nle = -1 where it is wider than ``wcap``; cells (B,) int64: the
    band's size; jwin (B, 2) int64: its first and last nonempty column,
    -1/-1 if none). Without ``crop`` the window is the whole [0, n]. With
    it, c0 = max(j0 - 1, 0) and nle = j1 - c0 + e, where e (0, 1 or 2)
    keeps the parity of the final column's two-buffer state."""
    lib = get_lib()
    xb = np.ascontiguousarray(xb, dtype=np.uint8)
    yb = np.ascontiguousarray(yb, dtype=np.uint8)
    mlens = np.ascontiguousarray(mlens, dtype=np.int64)
    nlens = np.ascontiguousarray(nlens, dtype=np.int64)
    B, Mmax = xb.shape
    Nmax = yb.shape[1]
    st_w = np.empty((B, wcap + 1), dtype=np.int32)
    en_w = np.empty((B, wcap + 1), dtype=np.int32)
    c0 = np.empty(B, dtype=np.int64)
    nle = np.empty(B, dtype=np.int64)
    cells = np.empty(B, dtype=np.int64)
    jwin = np.empty((B, 2), dtype=np.int64)
    lib.band_build_batch(
        _ptr(xb, _u8p), _ptr(mlens, _i64p), Mmax, _ptr(yb, _u8p), _ptr(nlens, _i64p), Nmax, B,
        int(k), int(w), *(int(c) for c in clips), int(match_score), int(go_neg), int(ge_neg),
        int(nthreads), 1 if crop else 0, int(wcap),
        _ptr(st_w, _i32p), _ptr(en_w, _i32p), _ptr(c0, _i64p), _ptr(nle, _i64p), _ptr(cells, _i64p),
        _ptr(jwin, _i64p),
    )
    return st_w, en_w, c0, nle, cells, jwin


def sais(transformed: np.ndarray, alphabet_size: int) -> np.ndarray:
    """O(n) suffix array of an integer text (values in [0,
    ``alphabet_size``)), dispatched as the JAX binding dispatches: a byte
    alphabet runs the u8-text kernel into an int32 SA below 2^31 - 1
    symbols (int64 on return below 2^27, int32 from there on: no 8n
    transient at genome scale), a uint32 SA below 2^32, an int64 one
    beyond; wider alphabets the int64 kernel. Raises ``RuntimeError`` when
    the library cannot be built."""
    lib = get_lib()
    n = len(transformed)
    if alphabet_size <= 256:
        t = np.ascontiguousarray(transformed, dtype=np.uint8)
        if n < 2**31 - 1:
            sa32 = np.empty(n, dtype=np.int32)
            lib.sais_u8_i32(_ptr(t, _u8p), n, int(alphabet_size), _ptr(sa32, _i32p))
            return sa32 if n >= (1 << 27) else sa32.astype(np.int64)
        if n < 2**32:
            return sais_u32(t, alphabet_size)
        sa = np.empty(n, dtype=np.int64)
        lib.sais_u8_i64(_ptr(t, _u8p), n, int(alphabet_size), _ptr(sa, _i64p))
        return sa
    t = np.ascontiguousarray(transformed, dtype=np.int64)
    sa = np.empty(n, dtype=np.int64)
    lib.sais_i64(_ptr(t, _i64p), n, int(alphabet_size), _ptr(sa, _i64p))
    return sa


def sais_u32(transformed: np.ndarray, alphabet_size: int) -> np.ndarray:
    """The u8-text / uint32-SA instantiation at any length (the path of
    texts of 2^31 to 2^32 - 1 symbols; callable on small texts so that the
    tests can hold it against the int32 one). ``ValueError`` for an
    alphabet wider than a byte."""
    if alphabet_size > 256:
        raise ValueError(f"sais_u32 takes byte alphabets, got {alphabet_size} symbols")
    lib = get_lib()
    t = np.ascontiguousarray(transformed, dtype=np.uint8)
    sa = np.empty(len(t), dtype=np.uint32)
    lib.sais_u8_u32(_ptr(t, _u8p), len(t), int(alphabet_size), _ptr(sa, _u32p))
    return sa


def cigars_colrle(ex, cnt, nlens, mlens, ins0, fix_exit, fix_ins, xstart, xend, nthreads: int = 0, cap=None):
    """CIGAR strings of a batch's column-RLE walk streams, threaded over
    lanes: a list of B strings, ``None`` for a row whose string does not fit
    its ``cap`` bytes (default 12 N + 48, the JAX binding's). ``ex`` /
    ``cnt`` (B, N) uint16 exit codes and Ins runs, row-major; the per-lane
    fields (B,) int32."""
    lib = get_lib()
    ex = np.ascontiguousarray(ex, dtype=np.uint16)
    cnt = np.ascontiguousarray(cnt, dtype=np.uint16)
    B, N = ex.shape
    if cnt.shape != (B, N):
        raise ValueError(f"ex {ex.shape} and cnt {cnt.shape}: expected equal (B, N) shapes")
    cap = 12 * N + 48 if cap is None else int(cap)
    out = np.empty(B * cap, dtype=np.uint8)
    out_len = np.empty(B, dtype=np.int32)
    lanes = [np.ascontiguousarray(v, dtype=np.int32) for v in (nlens, mlens, ins0, fix_exit, fix_ins, xstart, xend)]
    if any(v.shape != (B,) for v in lanes):
        raise ValueError(f"per-lane fields must have shape ({B},)")
    if B and int(lanes[0].max()) > N:
        raise ValueError(f"nlens must not pass the stream's {N} columns")
    lib.cigars_colrle(
        _ptr(ex, _u16p), _ptr(cnt, _u16p), B, N, *(_ptr(v, _i32p) for v in lanes), cap,
        out.ctypes.data_as(ctypes.c_char_p), _ptr(out_len, _i32p), int(nthreads),
    )
    raw = out.tobytes()
    return [None if out_len[b] < 0 else raw[b * cap : b * cap + int(out_len[b])].decode() for b in range(B)]
