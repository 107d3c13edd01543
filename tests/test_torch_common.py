"""Shared inputs of the graphchainer_torch tests, and the port's import
rules.

The port's tests hold graphchainer_torch to graphchainer_tpu on the same
numpy inputs, with exact equality: the DP is integer arithmetic plus a
float32 band ramp that is IEEE on both sides.  The input factories here are
cached per process, so the test files of one worker share them.
"""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from graphchainer_tpu.graph.alignment_graph import build_alignment_graph
from graphchainer_tpu.graph.mpc import build_mpc
from graphchainer_tpu.graph.simulate import generate_path, simulate_reads
from graphchainer_tpu.index.minimizer import build_index
from graphchainer_tpu.utils.seq import match_masks
from graphchainer_torch import convert
from graphchainer_torch.align.anchors import level_bucket

from test_mpc import random_dag_bigraph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_fixtures")

# the text of tests/conftest.py's toy_gfa (the reference's test/graph.gfa),
# for code that runs outside pytest's fixtures (make_fixtures.py)
TOY_GFA_TEXT = ("S\t1\tACGTCATGCAGTCGTAACGTAGTCGTCACAGTCAGTCGTAGCTA\n"
                "S\t2\tA\n"
                "S\t3\tT\n"
                "S\t4\tGTAGCGTCAGTCAGTCAGTCGTAGCGTAACGTCGTAGTCAGT\n"
                "L\t1\t+\t2\t+\t0M\n"
                "L\t1\t+\t3\t+\t0M\n"
                "L\t2\t+\t4\t+\t0M\n"
                "L\t3\t+\t4\t+\t0M\n")

# The port's CPU tests run many small torch ops; with one pytest-xdist
# worker per core, torch's per-process intra-op thread pool would
# oversubscribe the machine, so torch runs single-threaded here.
torch.set_num_threads(1)


def t64(a) -> torch.Tensor:
    """numpy (or jax) array -> int64 CPU tensor."""
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def load_fixture(name):
    """A recorded output of the JAX package: tests/torch_fixtures/
    NAME.json, written by tests/torch_fixtures/make_fixtures.py (and held
    to a live run by tests/test_torch_fixtures.py, marked slow)."""
    with open(os.path.join(FIXTURES, name + ".json")) as fh:
        return json.load(fh)


def aln_record(a) -> dict:
    """The compared fields of an alignment, as JSON values."""
    return dict(
        name=a.name, score=int(a.score),
        positions=np.asarray(a.positions, dtype=np.int64).reshape(
            -1, 2).tolist(),
        ops=None if a.ops is None else np.asarray(a.ops).astype(
            np.int64).tolist(),
        seq_start=int(a.seq_start), seq_end=int(a.seq_end),
        n_seeds=int(a.n_seeds), n_anchors=int(a.n_anchors),
        n_chained=int(a.n_chained),
        secondary=[aln_record(s) for s in a.secondary])


def array_record(a) -> dict:
    """An integer array as JSON values: its dtype, shape and elements."""
    a = np.asarray(a)
    return dict(dtype=str(a.dtype), shape=list(a.shape),
                data=a.reshape(-1).astype(np.int64).tolist())


def record_array(rec: dict) -> np.ndarray:
    """The array that array_record wrote."""
    return np.array(rec["data"], dtype=rec["dtype"]).reshape(rec["shape"])


def output_record(data: dict) -> dict:
    """Output files' bytes as JSON values: GAM (binary, decompressed) as
    hex, every text output as text."""
    return {k: (v.hex() if k == "gam" else v.decode())
            for k, v in data.items()}


@functools.lru_cache(maxsize=None)
def slice_case():
    """A small random DAG whose source-to-sink path is ~570 bp, its
    indices, and 7 reads: 6 of ~500 bp at 10% error and one at 50% error
    (first), which the slice configuration sends to the band escalation.
    Returns (g, mpc, index, path_seq, reads)."""
    rng = np.random.default_rng(2)
    bg = random_dag_bigraph(rng, n_seg=24, p_edge=0.15, max_len=300)
    g = build_alignment_graph(bg)
    mpc = build_mpc(g)
    index = build_index(g, k=11, w=6)
    path_seq, _ = generate_path(g, seed=5)
    reads = simulate_reads(path_seq, 6, min(len(path_seq), 500), seed=8,
                           error_rate=0.10, len_std=50)
    noisy = simulate_reads(path_seq, 1, 500, seed=3, error_rate=0.5)
    reads.insert(0, ("noisy",) + (noisy[0][1],))
    return g, mpc, index, path_seq, reads


def port_graph(g):
    """The port's AlignmentGraph with the fields of the JAX package's."""
    return convert.from_reference_graph(vars(g))


def port_mpc(mpc):
    return convert.from_reference_mpc(vars(mpc))


def port_index(index):
    return convert.from_reference_index(vars(index))


@functools.lru_cache(maxsize=None)
def slice_case_port():
    """slice_case() with the graph and both indices as the port's own
    classes, carried across by convert.py."""
    g, mpc, index, path_seq, reads = slice_case()
    return port_graph(g), port_mpc(mpc), port_index(index), path_seq, reads


@functools.lru_cache(maxsize=None)
def frag_batch(B: int, max_in: int = 4, slack: int = 8):
    """The port's fragment batch of slice_case()'s reads: (model, jobs,
    frags, band_nodes, band_nodes_cat, band_in, seed_shift, req, rows, S,
    band_level) from the native seed+window stage and
    assemble_batch_cols."""
    from graphchainer_torch.align.anchors import assemble_batch_cols
    from graphchainer_torch.models.chainer import ChainerConfig, ChainerModel
    g, mpc, index, _, reads = slice_case_port()
    model = ChainerModel(g, mpc, index, ChainerConfig(band_slots=B),
                         device="cpu")
    jobs, frags, _ = model._fragment_jobs_cols(reads)
    mm = match_masks("".join(s for _, s in reads))
    base = np.zeros(len(reads) + 1, dtype=np.int64)
    np.cumsum([len(s) for _, s in reads], out=base[1:])
    arrs = assemble_batch_cols(model.gx, jobs, mm, base, B=B,
                               max_in=max_in, slack=slack)
    return (model, jobs, frags) + tuple(arrs)


def padded_batch(B):
    """frag_batch(B) with the bands padded back to exactly B slots (the
    adaptive width trims this graph's bands to 8): pad slots are empty,
    as in a batch whose widest band fills B slots."""
    (model, jobs, frags, band_nodes, bnc, bi, ss, req, rows, S,
     bl) = frag_batch(B)
    pad = B - bnc.shape[1]
    bnc = np.pad(bnc, ((0, 0), (0, pad)), constant_values=-1)
    bi = np.pad(bi, ((0, 0), (0, pad), (0, 0)), constant_values=-1)
    bl = np.pad(bl, ((0, 0), (0, pad)), constant_values=-1)
    return model, bnc, bi, ss, req, rows, S, bl


def host_args(B, padded=True):
    """frag_kernel.frag_core's arguments for frag_batch(B) on the CPU,
    fragment-major in the band build's host types (int32 ids, int8
    in-edges and levels, uint32 words as int32 bits), with the bands
    padded to B or at the batch's own width B_eff."""
    if padded:
        model, bnc, bi, ss, req, rows, S, bl = padded_batch(B)
    else:
        model, _, _, _, bnc, bi, ss, req, rows, S, bl = frag_batch(B)
    gx = model.gx

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))
    args = (t(gx.node_eq_cat.view(np.int32)), t(gx.node_len_cat), t(bnc),
            t(bi), t(bl), t(ss), t(req.view(np.int32)), t(rows))
    return args, dict(S=S, max_in=4, n_levels=level_bucket(bl, bnc.shape[1]))


def lane_major_inputs(B, padded=True):
    """The transposed core inputs, built exactly as align_fragments_tl
    builds them (as in tests/test_pallas_frag.py), with the bands padded
    to B or at the batch's own width B_eff."""
    if padded:
        model, bnc, bi, ss, req, rows, S, bl = padded_batch(B)
    else:
        model, _, _, _, bnc, bi, ss, req, rows, S, bl = frag_batch(B)
    gx = model.gx
    N2 = gx.node_eq_cat.shape[0]
    ids = bnc.astype(np.int64)
    idc = np.clip(ids, 0, N2 - 1)
    slot_eq = gx.node_eq_cat[idc]
    slot_len = np.where(ids >= 0, gx.node_len_cat[idc], 0)
    shift = np.zeros_like(slot_len)
    shift[:, 0] = ss
    slot_eq = slot_eq >> (shift.astype(np.uint32) & 31)[..., None]
    slot_len = slot_len - shift
    F = bnc.shape[0]
    args = (np.transpose(slot_eq, (2, 1, 0)).astype(np.uint32),
            np.transpose(slot_len, (1, 0)).astype(np.int32),
            np.transpose(bi.astype(np.int32), (2, 1, 0)),
            np.transpose(bl.astype(np.int32), (1, 0)),
            np.transpose(req, (1, 2, 0)).astype(np.uint32),
            rows.astype(np.int32)[None, :], np.zeros((1, F), np.int32))
    return args, dict(S=S, max_in=4,
                      n_levels=level_bucket(bl, bnc.shape[1]))


def polish_arrays(rng, R, RMAX, PMAX, err=0.08):
    """Random reads vs their paths as lane-major polish-core inputs
    (planes_t (4, RMAX/32, R), path_t (PMAX, R), read and path lengths);
    the generator of tests/test_pallas_polish.make_batch, as numpy."""
    reads, paths = [], []
    for _ in range(R):
        L = int(rng.integers(40, PMAX - 10))
        path = "".join(rng.choice(list("ACGT"), L))
        read = list(path)
        for _ in range(int(L * err)):
            p = int(rng.integers(0, len(read)))
            op = int(rng.integers(0, 3))
            if op == 0:
                read[p] = str(rng.choice(list("ACGT")))
            elif op == 1 and len(read) > 2:
                del read[p]
            else:
                read.insert(p, str(rng.choice(list("ACGT"))))
        reads.append("".join(read)[:RMAX])
        paths.append(path)
    return pack_polish_pairs(list(zip(reads, paths)), RMAX, PMAX)


def pack_polish_pairs(pairs, RMAX, PMAX):
    """(read, path) strings as lane-major polish-core inputs: planes_t
    (4, RMAX/32, R), path_t (PMAX, R), read and path lengths."""
    R = len(pairs)
    planes_t = np.zeros((4, RMAX // 32, R), np.uint32)
    path_t = np.zeros((PMAX, R), np.uint32)
    for i, (rd, pt) in enumerate(pairs):
        mm = match_masks(rd)
        for j, v in enumerate(mm):
            for b in range(4):
                if (v >> b) & 1:
                    planes_t[b, j // 32, i] |= np.uint32(1) << (j % 32)
        path_t[:len(pt), i] = match_masks(pt)
    return (planes_t, path_t, np.array([len(r) for r, _ in pairs], np.int32),
            np.array([len(p) for _, p in pairs], np.int32))


def mixed_batch():
    """12 reads vs paths; every third path is cut to 48 chars, so those
    reads' bands move several words per column (the reference's slow
    branch) while the others move by at most one (its fast branch)."""
    rng = np.random.default_rng(5)
    planes_t, path_t, rl, pl = polish_arrays(rng, R=12, RMAX=512, PMAX=512)
    pl = np.where(np.arange(12) % 3 == 0, np.minimum(pl, 48), pl)
    return planes_t, path_t, rl, pl.astype(np.int32)


@pytest.fixture
def cuda_device():
    """A CUDA device for tests of the kernels themselves (they have no
    CPU mode); skips where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


_PORT_MODULES = [
    "graphchainer_torch", "graphchainer_torch.cli",
    "graphchainer_torch.pipeline", "graphchainer_torch.models.chainer",
    "graphchainer_torch.ops.frag_align", "graphchainer_torch.ops.frag_kernel",
    "graphchainer_torch.ops.linear_align",
    "graphchainer_torch.ops.polish_kernel",
    "graphchainer_torch.ops.chain_scan", "graphchainer_torch.ops.myers",
    "graphchainer_torch.ops._cuda",
    "graphchainer_torch.align.anchors", "graphchainer_torch.align.chaining",
    "graphchainer_torch.align.polish", "graphchainer_torch.align.emit",
    "graphchainer_torch.align.correctness", "graphchainer_torch.align.evalue",
    "graphchainer_torch.align.selection", "graphchainer_torch.align.stitch",
    "graphchainer_torch.models.aligner", "graphchainer_torch.models.optimal",
    "graphchainer_torch.align.oracle", "graphchainer_torch.align.seedless",
    "graphchainer_torch.io.gaf", "graphchainer_torch.io.gfa",
    "graphchainer_torch.io.gam", "graphchainer_torch.io.gam_reader",
    "graphchainer_torch.io.vg_wire", "graphchainer_torch.io.vg_graph",
    "graphchainer_torch.io.fastq", "graphchainer_torch.native",
    "graphchainer_torch.constants", "graphchainer_torch.convert",
    "graphchainer_torch.utils.bits", "graphchainer_torch.utils.seq",
    "graphchainer_torch.utils.timers",
    "graphchainer_torch.graph.alignment_graph",
    "graphchainer_torch.graph.mpc", "graphchainer_torch.graph.simulate",
    "graphchainer_torch.index.minimizer", "graphchainer_torch.index.mem",
    "graphchainer_torch.parallel", "graphchainer_torch.parallel.multihost",
    "graphchainer_torch.parallel.device",
    "graphchainer_torch.parallel.collectives",
    "graphchainer_torch.parallel.sharded_graph",
    "graphchainer_torch.parallel.mesh", "graphchainer_torch.tools",
    "graphchainer_torch.workload", "chip_smoke",
]


@pytest.mark.timeout(600)
def test_port_imports_without_jax():
    """Every module of the port, and chip_smoke, imports with jax and the
    JAX package both blocked."""
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['graphchainer_tpu'] = None\n"
            f"for m in {_PORT_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m, v in sys.modules.items()\n"
            "       if m.split('.')[0] in ('jax', 'graphchainer_tpu')\n"
            "       and v is not None]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_port_sources_never_import_jax():
    """No file of the port, nor chip_smoke.py, names jax or the JAX
    package in an import."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(REPO,
                                                  "graphchainer_torch")):
        files += [os.path.join(dirpath, f) for f in names
                  if f.endswith(".py")]
    banned = ("import jax", "from jax", "import graphchainer_tpu",
              "from graphchainer_tpu")
    offenders = []
    for p in files:
        with open(p) as fh:
            for n, line in enumerate(fh, 1):
                if line.strip().startswith(banned):
                    offenders.append(f"{p}:{n}")
    assert len(files) > 30 and not offenders, offenders


def test_toy_gfa_text_is_conftests(toy_gfa):
    with open(toy_gfa) as fh:
        assert fh.read() == TOY_GFA_TEXT


def test_slice_case_has_escalation_read():
    """The shared case keeps a read noisy enough to escalate."""
    _, _, _, path_seq, reads = slice_case()
    assert len(path_seq) > 500 and reads[0][0] == "noisy"
    assert all(400 <= len(s) <= 700 for _, s in reads)
