"""Global constants of the engine.

Copy of graphchainer_tpu/constants.py, so the port imports nothing of the
JAX package.

Design note (vs reference): the reference packs 64 read rows per DP slice and
splits graph nodes into <=64bp chunks (SPLIT_NODE_SIZE=64, reference
src/AlignmentGraph.h:20).  This engine uses 32-bit Myers words, 32 read rows
per slice and <=32bp split nodes, the JAX package's formats, so outputs
compare bit for bit.  All bit-parallel state (VP/VN/Eq/HP/HN) is uint32.
"""

# Myers word width == rows per DP slice == max split-node length (bp).
WORD = 32

# Max bases per split node (columns per node DP block).
SPLIT_LEN = 32

# Base encoding: A=0, C=1, G=2, T=3.  Ambiguous IUPAC bases are represented
# directly in the per-node Eq bitplanes (a base that matches several letters
# sets its bit in several planes), which subsumes the reference's separate
# AmbiguousChunkSequence path (reference src/AlignmentGraph.h:36-68).
BASES = "ACGT"
BASE_TO_CODE = {"A": 0, "C": 1, "G": 2, "T": 3}

# IUPAC -> set of matched bases (used to build Eq bitplanes).
IUPAC = {
    "A": "A", "C": "C", "G": "G", "T": "T", "U": "T",
    "R": "AG", "Y": "CT", "S": "CG", "W": "AT", "K": "GT", "M": "AC",
    "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG", "N": "ACGT",
    "-": "ACGT",
}

# Default parameters mirroring the reference CLI defaults
# (reference src/AlignerMain.cpp:186-209).
DEFAULT_SEED_MINIMIZER_LENGTH = 15
DEFAULT_SEED_MINIMIZER_WINDOW = 20
DEFAULT_SEED_MINIMIZER_DENSITY = 10.0
DEFAULT_BANDWIDTH = 10
DEFAULT_COLINEAR_GAP = 10_000
DEFAULT_COLINEAR_SPLIT_LEN = 35
DEFAULT_COLINEAR_SPLIT_GAP = 35
DEFAULT_MAX_CLUSTER_EXTEND = 10
DEFAULT_SEED_EXTEND_DENSITY = 0.002

# Padded CSR widths for device-side neighbor gathers.  Nodes with higher
# degree are handled by the host fallback paths; variation graphs after
# split-node transformation almost never exceed these.
MAX_IN_DEGREE = 4
MAX_OUT_DEGREE = 8
