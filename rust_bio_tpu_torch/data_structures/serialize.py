"""FM-index files (port of ``rust_bio_tpu.data_structures.serialize``;
reference: the serde derives on Occ bwt.rs:76, FMIndex fmindex.rs:213,
SampledSuffixArray suffix_array.rs:125).

An index is one ``.npz`` holding the arrays ``bits`` (S, nw) uint32,
``ckpt`` (S, nw) int32, ``less`` (257,), ``sym_of`` (256,) int32,
``bwt_bytes`` (n,) uint8, and where the index can locate ``sa_sample``,
``sent_rows`` and ``sent_vals``; where it has a q-mer table ``lut`` (4^q,
2) and ``lut_rank`` (256,) int32. Index values are int32, or uint32 in the
uint32 index (from 2^31 symbols on, or built with ``force_u32``). A JSON
header ``__meta__`` holds ``format_version``, ``kind``, ``n``, ``s``,
``sentinel``, ``symbols``, ``lut_q``, a content hash over the arrays, and
the caller's ``extra_meta`` (the read mapper records its genome's hash
there). Files written here load in the JAX package's ``load_fm_index`` and
the reverse, byte for byte the same arrays and hash.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

from rust_bio_tpu_torch._device import resolve_device
from rust_bio_tpu_torch.data_structures.fm_device import DeviceFMIndex

FORMAT_VERSION = 1


def _content_hash(arrays: dict) -> str:
    h = hashlib.sha256()
    for key in sorted(arrays):
        h.update(key.encode())
        h.update(np.ascontiguousarray(arrays[key]).tobytes())
    return h.hexdigest()[:16]


def _values(t: torch.Tensor, big: bool) -> np.ndarray:
    """Host numpy of an int32 index tensor: uint32 in the uint32 index."""
    a = t.cpu().numpy()
    return a.view(np.uint32) if big else a


def save_fm_index(path, device_index: DeviceFMIndex, compress: bool = True, extra_meta: dict | None = None) -> None:
    """Write ``device_index`` as a versioned, hashed ``.npz``. ``extra_meta``
    entries are merged into the header, so a loader can check where the
    index came from without reading its arrays; ``compress=False`` skips
    zlib (genome-scale indexes write in seconds instead of minutes)."""
    big = device_index._big
    arrays = {
        "bits": device_index.bits.cpu().numpy().view(np.uint32),
        "ckpt": device_index.ckpt.cpu().numpy(),
        "less": _values(device_index.less, big),
        "sym_of": device_index.sym_of.cpu().numpy(),
        "bwt_bytes": device_index.bwt_host(),
    }
    if device_index.sa_sample is not None:
        arrays["sa_sample"] = _values(device_index.sa_sample, big)
        arrays["sent_rows"] = _values(device_index.sent_rows, big)
        arrays["sent_vals"] = _values(device_index.sent_vals, big)
    if device_index._lut_q is not None:
        arrays["lut"] = _values(device_index._lut, big)
        arrays["lut_rank"] = device_index._lut_rank.cpu().numpy()
    meta = {
        "format_version": FORMAT_VERSION,
        "kind": "fm_index",
        "n": int(device_index.n),
        "s": int(device_index.s),
        "sentinel": int(device_index.sentinel),
        "symbols": list(device_index.symbols),
        "lut_q": int(device_index._lut_q or 0),
        "hash": _content_hash(arrays),
        **(extra_meta or {}),
    }
    saver = np.savez_compressed if compress else np.savez
    saver(path, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8), **arrays)


def fm_index_from_arrays(arrays: dict, meta: dict, device=None) -> DeviceFMIndex:
    """The port's ``DeviceFMIndex`` from the arrays and header of an index
    file (``device=None`` means CUDA)."""
    dev = resolve_device(device)
    idx = DeviceFMIndex.__new__(DeviceFMIndex)
    if "lut" in arrays:
        arrays = {**arrays, "lut_q": int(meta.get("lut_q", 12))}
    idx._set_tables(arrays, int(meta["n"]), int(meta["s"]), int(meta["sentinel"]), meta["symbols"], dev)
    return idx


def read_meta(path) -> dict:
    """The header of an index file, without reading its arrays."""
    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"]).decode())


def load_fm_index(path, device=None, verify: bool = True, return_meta: bool = False):
    """Read an index file (this module's or the JAX package's) into a
    ``DeviceFMIndex`` on ``device`` (``None`` means CUDA). Raises
    ``ValueError`` on another format and, with ``verify``, when the content
    hash does not match the header. ``return_meta=True`` returns
    ``(index, header)``."""
    dev = resolve_device(device)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    if meta.get("format_version") != FORMAT_VERSION or meta.get("kind") != "fm_index":
        raise ValueError(f"unsupported index file: format {meta.get('format_version')}, kind {meta.get('kind')}")
    if verify:
        got = _content_hash(arrays)
        if got != meta["hash"]:
            raise ValueError(f"index file corrupted: hash {got} != {meta['hash']}")
    idx = fm_index_from_arrays(arrays, meta, dev)
    return (idx, meta) if return_meta else idx
