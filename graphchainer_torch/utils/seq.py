"""Sequence helpers: reverse complement, encoding (reference
src/CommonUtils.cpp).  Copy of graphchainer_tpu/utils/seq.py."""
from __future__ import annotations

import numpy as np

from graphchainer_torch.constants import BASE_TO_CODE, IUPAC

_COMP = str.maketrans(
    "ACGTUMRWSYKVHDBNacgtumrwsykvhdbn",
    "TGCAAKYWSRMBDHVNtgcaakywsrmbdhvn")


def revcomp(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


def encode(seq: str) -> np.ndarray:
    """Encode A/C/G/T as 0..3; ambiguous bases map to 0 (A).

    Use eq_masks() when ambiguity codes must match multiple letters.
    """
    out = np.zeros(len(seq), dtype=np.int32)
    for i, ch in enumerate(seq):
        out[i] = BASE_TO_CODE.get(ch, 0)
    return out


_EQ_LUT = np.zeros(256, dtype=np.uint8)  # bitmask over {A,C,G,T}
for _ch, _matches in IUPAC.items():
    _mask = 0
    for _m in _matches:
        _mask |= 1 << BASE_TO_CODE[_m]
    _EQ_LUT[ord(_ch)] = _mask
    _EQ_LUT[ord(_ch.lower())] = _mask


def match_masks(seq: str) -> np.ndarray:
    """Per-position 4-bit base match mask (bit b set iff position matches
    base code b), honouring IUPAC ambiguity codes."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _EQ_LUT[raw]


def eq_bitplanes(seq: str, width: int) -> np.ndarray:
    """Pack a sequence (len <= width<=32) into 4 uint32 Eq bitplanes:
    bit j of plane b is set iff seq[j] matches base b."""
    mm = match_masks(seq).astype(np.uint32)
    planes = np.zeros(4, dtype=np.uint32)
    for b in range(4):
        bits = (mm >> b) & 1
        planes[b] = np.bitwise_or.reduce(bits << np.arange(len(mm), dtype=np.uint32)) if len(mm) else 0
    return planes
