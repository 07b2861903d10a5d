"""State carried across from the JAX package: FM-index files.

``rust_bio_tpu.data_structures.serialize.save_fm_index`` writes an index as
one ``.npz`` with the arrays ``bits``, ``ckpt``, ``less``, ``sym_of``,
``bwt_bytes`` (and ``sa_sample``, ``sent_rows``, ``sent_vals`` when the
index can locate; ``lut`` and ``lut_rank`` when it has a q-mer table) and a
JSON header ``__meta__`` holding ``n``, ``s``, ``sentinel``, ``symbols``,
``lut_q`` and a content hash. ``load_fm_index`` reads that file, checks
the hash the same way, and returns the port's ``DeviceFMIndex``;
``fm_index_from_arrays`` does the same from the arrays and header already
in memory. Both live in ``data_structures.serialize``, which also writes
such files (``save_fm_index``). Index caches built by the JAX package load unchanged: a uint32
index (from 2^31 symbols on, or saved with ``force_u32``, its ``less``
uint32) loads as the port's uint32 index, a table with its ``lut_q``.

A scoring needs no converter: it is a handful of integers plus, for
substitution matrices, a (256, 256) int32 table (``Scoring.dense_lut``),
which both packages take as they are. The long-sequence global path
(K13/K14) adds nothing to carry: its parameters are the scoring's.

The banded aligner carries its bands and penalties: ``banded_inputs``
takes the JAX package's K16 inputs (``starts``/``ends`` (B, N+1) band
rows, the ``pen8`` vector (gap_open, gap_extend, xclip_prefix,
xclip_suffix, yclip_prefix, yclip_suffix, match, mismatch)) as numpy and
gives the port's (``ops.sw.scan_banded``'s ``starts``, ``ends``, ``pens8``).

The PairHMM family carries its derived parameters: ``pairhmm_from_params``
builds the port's class from those of a JAX object, as plain floats and
numpy arrays (``BatchPairHMM.g``, the fields of ``BatchPairHMMExact.g``,
``BatchHomopolyPairHMM.p``); both packages then compute the same thing.

The batched HMM carries its float32 arrays: ``hmm_from_jax`` reads ``A``,
``Bm``, ``pi`` and ``end`` of a JAX ``BatchDiscreteHMM`` (and ``mu``,
``log_norm`` and ``inv2var`` of a ``BatchGaussianHMM``) as numpy and
builds the port's class from them.
"""

from __future__ import annotations

import numpy as np
import torch

from rust_bio_tpu_torch._device import resolve_device
from rust_bio_tpu_torch.data_structures.serialize import fm_index_from_arrays, load_fm_index
from rust_bio_tpu_torch.stats import pairhmm
from rust_bio_tpu_torch.stats.hmm import device as hmm_device

__all__ = ["banded_inputs", "fm_index_from_arrays", "hmm_from_jax", "load_fm_index", "pairhmm_from_params"]


def banded_inputs(starts, ends, pen8, device=None):
    """(starts, ends (B, N+1) int32 tensors on ``device``, pens8 a tuple of
    8 ints) from the JAX package's banded-kernel inputs as numpy arrays
    (``device=None`` means CUDA)."""
    dev = resolve_device(device)
    st, en = (torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev) for a in (starts, ends))
    if st.shape != en.shape or st.dim() != 2:
        raise ValueError(f"starts {tuple(st.shape)} and ends {tuple(en.shape)}: expected equal (B, N+1) shapes")
    pens8 = tuple(int(v) for v in np.asarray(pen8).reshape(-1))
    if len(pens8) != 8:
        raise ValueError(f"pen8: expected 8 penalties, got {len(pens8)}")
    return st, en, pens8


def pairhmm_from_params(kind: str, params: dict, device=None, dtype=torch.float32):
    """The port's PairHMM class ``kind`` from a JAX object's derived
    parameters (``device=None`` means CUDA):

    - ``"BatchPairHMM"`` / ``"BatchPairHMMLinear"``: ``params`` is its ``g``,
      seven floats; ``dtype`` as the JAX object's (the log-space kernel's);
    - ``"BatchPairHMMExact"``: the fields of its ``g`` as a dict
      (``vars(obj.g)``);
    - ``"BatchHomopolyPairHMM"``: its ``p``, floats and length-4 arrays, and
      ``dtype`` as the JAX object's (its -inf surrogate follows the dtype).
    """
    if kind in ("BatchPairHMM", "BatchPairHMMLinear"):
        return getattr(pairhmm, kind).from_g(params, dtype, device)
    if kind == "BatchPairHMMExact":
        return pairhmm.BatchPairHMMExact.from_fields(params, device)
    if kind == "BatchHomopolyPairHMM":
        return pairhmm.BatchHomopolyPairHMM.from_p(params, dtype, device)
    raise ValueError(
        f"kind {kind!r}: expected BatchPairHMM, BatchPairHMMLinear, BatchPairHMMExact or BatchHomopolyPairHMM"
    )


def hmm_from_jax(model, device=None):
    """The port's ``BatchDiscreteHMM`` or ``BatchGaussianHMM`` from a JAX
    model of that class (``device=None`` means CUDA): its arrays are read
    as numpy, so both then compute the same thing (the port's backward
    scan starts from ``end``, where JAX's starts from zeros)."""
    arr = lambda name: np.asarray(getattr(model, name), np.float32)  # noqa: E731
    if hasattr(model, "mu"):
        return hmm_device.BatchGaussianHMM.from_arrays(
            arr("A"), arr("pi"), arr("end"), arr("mu"), arr("log_norm"), arr("inv2var"), device=device
        )
    return hmm_device.BatchDiscreteHMM(arr("A"), arr("Bm"), arr("pi"), arr("end"), device=device)
