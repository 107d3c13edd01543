"""The yardstick of the kernel metrics: the card's peaks and the bytes each
kernel's stage needs, counted from its algorithmic inputs and outputs.

Bytes, not operations, bound every roofline here: the kernels are integer
bit-parallel DPs and the H100 publishes no integer rate that fits them
(its 67 TFLOP/s is the float32 FMA rate), so a share of operations over a
borrowed peak would mean nothing.  ops_per_byte states each count's
arithmetic intensity beside it, for the reader to judge the bound.

- frag_core_bytes: one launch of the fragment DP, from its shapes: the
  band arrays (slot node ids int32, in-edge slots int8 x max_in, levels
  int8), seed shifts and row counts (int32), the read's row planes
  (4 words of 32 rows a slice), the node table row each slot names
  (16 bytes of match words and a 4-byte length), and the results written
  (best score, slot and column int32 a fragment, best in-edge int8 a
  slot and slice); the carried entry adds the carried state read
  (3 int32 a slot), the state written (3 int32 a slot) and the X cells
  (3 int32 a fragment) when it asks for them.
- polish_bytes: one polish of an aligned read, from what the GAF line
  says of it: the read's bases and the path's bases at 2 bits each, the
  edit ops written at 2 bits each, two int32 lengths.  The fill's
  intermediate dump is how today's kernels split the work, not work the
  stage needs, so it is not counted.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 80 GB, NVIDIA's data sheet, at its 700 W limit.
HBM_BYTES_PER_S = 3.35e12


def frag_core_bytes(F: int, B: int, S: int, max_in: int, carried: bool,
                    per_slot: bool = False, want_state: bool = False,
                    want_xcells: bool = False) -> int:
    band = F * B * (4 + max_in + 1)
    shifts = (F * B if per_slot else F) * 4
    rows = F * 4
    planes = F * S * 16
    node_rows = F * B * 20
    results = F * 12 + F * B * S
    extra = 0
    if carried:
        extra += F * B * 12
        if want_state:
            extra += F * B * 12
        if want_xcells:
            extra += F * 12
    return band + shifts + rows + planes + node_rows + results + extra


def frag_core_ops(F: int, B: int, S: int, max_in: int) -> int:
    """Integer operations of the DP over full slots: per slice and slot
    ~66 a merge candidate (the slot and its in-edges) and ~22 a column of
    32 (chip_smoke.py's model, stated for ops_per_byte only)."""
    return S * B * F * (66 * (1 + max_in) + 22 * 32)


def polish_bytes(read_len: int, path_len: int, n_ops: int) -> int:
    return (read_len + path_len + n_ops + 3) // 4 + 8


def polish_ops(read_len: int, path_len: int, bw: int = 8) -> int:
    """~25 integer operations a band word a column (fill) and ~40 a step of
    the walk (stated for ops_per_byte only)."""
    return 25 * path_len * bw + 40 * (read_len + path_len)


def bound_s(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S
