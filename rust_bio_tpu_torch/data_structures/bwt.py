"""Burrows-Wheeler transform on the device, and the host ``Occ`` and
``less`` arrays (port of ``rust_bio_tpu.data_structures.bwt``; reference:
bwt.rs:39, :76-186). ``Occ`` and ``less`` are numpy: they back the host
``FMIndex``, the SMEM oracle (``fmindex.FMDIndex``)."""

from __future__ import annotations

import numpy as np
import torch

from rust_bio_tpu_torch.alphabets import Alphabet
from rust_bio_tpu_torch.data_structures.suffix_array import as_text_tensor
from rust_bio_tpu_torch.utils.text import to_array


def bwt(text, sa: torch.Tensor) -> torch.Tensor:
    """BWT (uint8 tensor on ``sa``'s device) of a sentinel-terminated text
    given its suffix array: ``text[sa - 1]``, with ``sa == 0`` reading the
    last symbol."""
    sa = torch.as_tensor(sa)
    arr = as_text_tensor(text, sa.device)
    n = arr.numel()
    if sa.shape != (n,):
        raise ValueError(f"suffix array of shape {tuple(sa.shape)} for a text of {n}")
    return arr[torch.remainder(sa.to(torch.int64) - 1, max(n, 1))]


class Occ:
    """Checkpointed occurrence counts, sampled every k rows (bwt.rs:76-182).

    ``occ[ckpt, a]`` = number of occurrences of symbol ``a`` in
    ``bwt[..ckpt*k+1]`` (i.e. counts *including* the checkpoint row), exactly
    as the reference stores them.
    """

    def __init__(self, bwt_arr, k: int, alphabet: Alphabet) -> None:
        b = to_array(bwt_arr)
        n = len(b)
        self.k = int(k)
        m = alphabet.max_symbol()
        assert m is not None, "Expecting non-empty alphabet."
        m += 1
        # occ[c, a] = occurrences of a in bwt[..c*k+1].  Built as a segmented
        # bincount + cumsum over checkpoint blocks — a dense (n, m) one-hot
        # prefix sum is O(n*m) memory (87 GiB at a 100 Mbp FMD text) while
        # the checkpoints themselves are only (ceil(n/k), m).
        n_ckpts = -(-n // k) if n else 0
        idx = np.nonzero(b < m)[0]
        sym = b[idx].astype(np.int64)
        # position i first appears in checkpoint ceil(i/k); positions past
        # the last stored checkpoint row contribute nowhere
        seg = (idx + k - 1) // k
        keep = seg < n_ckpts
        flat = np.bincount(
            seg[keep] * m + sym[keep], minlength=max(n_ckpts, 1) * m
        )
        self.occ = np.cumsum(
            flat[: n_ckpts * m].reshape(n_ckpts, m), axis=0, dtype=np.int64
        )

    def get(self, bwt_arr, r: int, a: int) -> int:
        """Occurrences of ``a`` in ``bwt[..r+1]``; O(k) (bwt.rs:129-182)."""
        b = bwt_arr if isinstance(bwt_arr, np.ndarray) else to_array(bwt_arr)
        k = self.k
        lo_ck = r // k
        lo_occ = int(self.occ[lo_ck, a])
        if k > 64:
            hi_ck = lo_ck + 1
            if hi_ck < len(self.occ):
                hi_occ = int(self.occ[hi_ck, a])
                if lo_occ == hi_occ:
                    return lo_occ
                hi_idx = hi_ck * k
                if (hi_idx - r) < k // 2:
                    return hi_occ - int(
                        np.count_nonzero(b[r + 1 : hi_idx + 1] == a)
                    )
        lo_idx = lo_ck * k
        return lo_occ + int(np.count_nonzero(b[lo_idx + 1 : r + 1] == a))

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Occ):
            return NotImplemented
        return self.k == other.k and np.array_equal(self.occ, other.occ)


def less(bwt_arr, alphabet: Alphabet) -> np.ndarray:
    """#symbols lexicographically smaller than each symbol (bwt.rs:186)."""
    b = to_array(bwt_arr)
    m = alphabet.max_symbol()
    assert m is not None, "Expecting non-empty alphabet."
    counts = np.bincount(b, minlength=m + 2)[: m + 2].astype(np.int64)
    # exclusive prefix sum (the reference's prescan)
    out = np.zeros_like(counts)
    np.cumsum(counts[:-1], out=out[1:])
    return out
