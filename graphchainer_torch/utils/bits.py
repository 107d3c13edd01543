"""Bit helpers for host-side tensor prep (copy of
graphchainer_tpu/utils/bits.py)."""
from __future__ import annotations

import numpy as np

_REV8 = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                 dtype=np.uint32)


def bitrev32(x: np.ndarray) -> np.ndarray:
    """Reverse the bits of each uint32."""
    x = np.asarray(x, dtype=np.uint32)
    return (_REV8[x & 0xFF] << 24 | _REV8[(x >> 8) & 0xFF] << 16
            | _REV8[(x >> 16) & 0xFF] << 8 | _REV8[(x >> 24) & 0xFF])


def reverse_eq_planes(eq: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Eq bitplanes of the reversed node sequences: bit j of the reversed
    plane = bit (len-1-j) of the forward plane."""
    lengths = np.asarray(lengths, dtype=np.uint32)
    rev = bitrev32(eq)
    shift = (np.uint32(32) - lengths)[..., None].astype(np.uint32)
    return (rev >> shift).astype(np.uint32)
