"""Suffix array construction (port of
``rust_bio_tpu.data_structures.suffix_array``; reference parity:
src/data_structures/suffix_array.rs).

Two routes, one array. A text handed over as bytes, str or numpy with
``device="cpu"`` runs the native O(n) SA-IS (``native.sais``, the JAX
package's route): the rank-recoded text as uint8, into an int32 SA below
2^31 - 1 symbols and a uint32 one from there to below 2^32 - 1
(``suffix_array_host``). Otherwise, a tensor or a text for the card, the
SA comes from prefix doubling with ``torch.argsort`` (O(n log n)
whole-array passes on the text's device, several 8n-byte arrays, an int64
key that overflows at 2^31 symbols): the plain version, and the oracle the
tests hold the native route against. The sentinel transform matches the
reference (later sentinels rank smaller), so the arrays equal the JAX
package's.
"""

from __future__ import annotations

import numpy as np
import torch

from rust_bio_tpu_torch._device import resolve_device
from rust_bio_tpu_torch.alphabets import Alphabet, RankTransform
from rust_bio_tpu_torch.utils.text import to_array


def as_text_tensor(text, device) -> torch.Tensor:
    """A (n,) uint8 tensor of ``text`` (bytes, str, numpy or tensor) on
    ``device``."""
    if isinstance(text, torch.Tensor):
        if text.dtype != torch.uint8 or text.dim() != 1:
            raise ValueError("text tensor must be 1-D uint8")
        return text.to(device)
    return torch.from_numpy(to_array(text).copy()).to(device)


def _sentinel_count(text: torch.Tensor) -> int:
    s = text[-1]
    if not bool((text >= s).all()):
        raise ValueError(
            "Expecting extra sentinel symbol being lexicographically smallest "
            "at the end of the text."
        )
    return int((text == s).sum())


def transform_text(
    text: torch.Tensor, alphabet: Alphabet, sentinel_count: int
) -> torch.Tensor:
    """Rank-recode text (int64); each sentinel gets a distinct descending
    rank (reference transform_text, suffix_array.rs:444-466): the i-th
    sentinel in text order maps to ``sentinel_count - 1 - i`` and every
    other symbol to ``rank + sentinel_count - 1``."""
    lut = torch.from_numpy(
        RankTransform(alphabet).lut.astype(np.int64) + (sentinel_count - 1)
    ).to(text.device)
    out = lut[text.long()]
    sent_pos = torch.nonzero(text == text[-1]).flatten()
    out[sent_pos] = sentinel_count - 1 - torch.arange(
        sentinel_count, dtype=torch.int64, device=text.device
    )
    return out


def _sa_prefix_doubling(rank0: torch.Tensor) -> torch.Tensor:
    """Suffix array (int64) of an integer text by prefix doubling: each
    round sorts suffixes by (rank of the first k symbols, rank of the next
    k) packed into one int64 key, until every rank is distinct."""
    n = rank0.numel()
    dev = rank0.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    rank = torch.unique(rank0, return_inverse=True)[1].to(torch.int64)
    k = 1
    while True:
        key2 = torch.full((n,), -1, dtype=torch.int64, device=dev)
        if k < n:
            key2[: n - k] = rank[k:]
        key = rank * (n + 1) + (key2 + 1)  # < n^2 + n: fits int64 for n < 2^31
        order = torch.argsort(key, stable=True)
        sorted_key = key[order]
        changed = torch.ones(n, dtype=torch.int64, device=dev)
        changed[1:] = (sorted_key[1:] != sorted_key[:-1]).to(torch.int64)
        rank = torch.empty_like(rank)
        rank[order] = torch.cumsum(changed, 0) - 1
        if int(rank[order[-1]]) == n - 1:
            return order
        k *= 2


def transform_text_host(arr: np.ndarray) -> np.ndarray:
    """``transform_text`` of a uint8 numpy text on the host, as uint8 (the
    JAX ``transform_text``'s dtype for at most 256 ranks): each sentinel a
    distinct descending rank, every other symbol its rank plus the
    sentinel count minus 1."""
    sc = _sentinel_count_host(arr)
    alphabet = Alphabet(np.unique(arr).tobytes())
    maxv = len(alphabet) - 1 + sc - 1
    if maxv >= 256:
        raise ValueError(f"{sc} sentinels: the recoded text does not fit a byte")
    ranks = (RankTransform(alphabet).lut.astype(np.int64) + (sc - 1)).astype(np.uint8)
    out = ranks[arr]
    out[np.flatnonzero(arr == arr[-1])] = (sc - 1 - np.arange(sc)).astype(np.uint8)
    return out


def _sentinel_count_host(arr: np.ndarray) -> int:
    s = arr[-1]
    if arr.min() < s:
        raise ValueError(
            "Expecting extra sentinel symbol being lexicographically smallest "
            "at the end of the text."
        )
    return int(np.count_nonzero(arr == s))


def suffix_array_host(text) -> np.ndarray:
    """Suffix array of a sentinel-terminated text on the host by the native
    SA-IS (JAX ``suffix_array``'s route): int64 below 2^27 symbols, int32
    from there to below 2^31 - 1, uint32 to below 2^32 - 1."""
    from rust_bio_tpu_torch import native

    arr = to_array(text)
    if len(arr) == 0:
        return np.zeros(0, dtype=np.int64)
    if len(arr) >= 2**32 - 1:
        raise ValueError(f"text of {len(arr)} symbols: the suffix array's index stops below 2^32 - 1")
    transformed = transform_text_host(arr)
    return native.sais(transformed, int(transformed.max()) + 1)


def suffix_array(text, device=None) -> torch.Tensor:
    """Suffix array (a tensor on ``device``) of a sentinel-terminated text;
    multi-sentinel texts allowed (reference: suffix_array.rs:264). A text
    that is not a tensor, with ``device="cpu"``, runs the native SA-IS
    (``suffix_array_host``: int64 below 2^27 symbols, int32 below 2^31 - 1,
    uint32 values as int64 beyond); anything else prefix doubling on the
    device (int64)."""
    dev = text.device if isinstance(text, torch.Tensor) and device is None else resolve_device(device)
    if not isinstance(text, torch.Tensor) and dev.type == "cpu":
        sa = suffix_array_host(text)
        return torch.from_numpy(sa.astype(np.int64) if sa.dtype == np.uint32 else sa)
    arr = as_text_tensor(text, dev)
    if arr.numel() == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    alphabet = Alphabet(torch.unique(arr).cpu().numpy().tobytes())
    transformed = transform_text(arr, alphabet, _sentinel_count(arr))
    return _sa_prefix_doubling(transformed)
