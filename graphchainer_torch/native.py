"""ctypes bindings for the C++ host runtime (native/graphchainer_native.cpp).

Copy of graphchainer_tpu/native.py with the bindings the port calls (the
rest come with the slices that need them).  The C++ source is shared: it
lies at the repository's root, outside both packages, and is read by path.
This package compiles it at first use with g++ -O3 into its own
graphchainer_torch/_build/, under a name keyed by a hash of the source and
the flags, and never loads or writes the JAX package's
native/graphchainer_native.so, so the two packages do not race on one
file.  All array arguments are numpy int64 arrays.
"""
from __future__ import annotations

import ctypes
import os
import platform
import subprocess
import threading
from dataclasses import dataclass

import numpy as np

from graphchainer_torch import _buildlib

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "native", "graphchainer_native.cpp")

_lock = threading.Lock()
_lib = None
build_seconds = None        # wall time of the g++ run that produced the
                            # loaded library (0.0 when it was already built)

_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _ptr(a: np.ndarray):
    assert a.dtype == np.int64 and a.flags.c_contiguous
    return a.ctypes.data_as(_I64P)


def _flags() -> list:
    # a fixed target per architecture, not -march=native: the library is
    # cached on disk and may be loaded on another host of the same family
    march = {"x86_64": ["-march=x86-64-v3"], "AMD64": ["-march=x86-64-v3"],
             "aarch64": ["-march=armv8.2-a"], "arm64": ["-march=armv8.2-a"]}
    return (["-O3"] + march.get(platform.machine(), [])
            + ["-std=c++17", "-shared", "-fPIC"])


def library_path() -> str:
    return _buildlib.hashed_path("gct_native", [_SRC], _flags())


def _make(out: str) -> None:
    cmd = ["g++"] + _flags() + ["-o", out, _SRC]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed ({r.returncode}):\n{r.stderr}")


def get_lib() -> ctypes.CDLL:
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        build_seconds = (_buildlib.build_once(so, _make)
                         if not os.path.exists(so) else 0.0)
        lib = ctypes.CDLL(so)
        lib.topo_order.restype = ctypes.c_int
        lib.scc_order.restype = ctypes.c_int64
        lib.approx_pos.restype = None
        lib.approx_pos.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                   _I64P, _I64P, _I64P, _I64P]
        lib.connected_components.restype = ctypes.c_int64
        lib.mpc_build.restype = ctypes.c_void_p
        lib.mpc_sizes.argtypes = [ctypes.c_void_p, _I64P]
        lib.mpc_copy.argtypes = [ctypes.c_void_p] + [_I64P] * 8
        lib.mpc_free.argtypes = [ctypes.c_void_p]
        lib.band_build.restype = ctypes.c_int64
        lib.band_build.argtypes = ([ctypes.c_int64, _I64P, _I64P, _I64P,
                                    ctypes.c_int64, _I64P, _I64P]
                                   + [ctypes.c_int64] * 5
                                   + [_I64P, _I64P, _I64P])
        lib.band_build_multi.restype = ctypes.c_int64
        lib.band_build_multi.argtypes = lib.band_build.argtypes
        lib.suffix_array.argtypes = [_U8P, ctypes.c_int64, _I64P]
        lib.matching_stats.argtypes = [_U8P, ctypes.c_int64, _I64P, _U8P,
                                       ctypes.c_int64, _I64P, _I64P, _I64P]
        _I8P = ctypes.POINTER(ctypes.c_int8)
        lib.join_anchors.restype = ctypes.c_void_p
        lib.join_anchors.argtypes = ([ctypes.c_int64] * 4 + [_I8P]
                                     + [_I64P] * 10 + [ctypes.c_int64]
                                     + [_I64P] * 6)
        lib.paths_sizes.argtypes = [ctypes.c_void_p, _I64P]
        lib.paths_copy.argtypes = [ctypes.c_void_p, _I64P, _I64P]
        lib.paths_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


@dataclass
class JobCols:
    """Columnar fragment-job batch (seed_window_batch's result)."""
    seed: np.ndarray      # (F,) int64 split-node id (slot 0 of the band)
    trim: np.ndarray      # (F,) int64 seed_trim_len
    rev: np.ndarray       # (F,) bool backward-extension job
    read_idx: np.ndarray  # (F,) int64 read of the batch
    lo: np.ndarray        # (F,) int64 read row range [lo, hi)
    hi: np.ndarray        # (F,) int64 (rev jobs consume rows hi-1 .. lo)

    def __len__(self):
        return len(self.seed)


def topo_order(n: int, src: np.ndarray, dst: np.ndarray):
    """Topological order of a DAG.  Returns (order, rank).

    Raises ValueError on a directed cycle (the engine requires a DAG, like
    the reference: src/AlignmentGraph.cpp:1298-1302).
    """
    lib = get_lib()
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    order = np.empty(n, dtype=np.int64)
    rank = np.empty(n, dtype=np.int64)
    rc = lib.topo_order(ctypes.c_int64(n), ctypes.c_int64(len(src)),
                        _ptr(src), _ptr(dst), _ptr(order), _ptr(rank))
    if rc != 0:
        raise ValueError(
            "The input sequence graph has a directed cycle; "
            "only DAGs are supported for chaining.")
    return order, rank


def scc_order(n: int, src: np.ndarray, dst: np.ndarray):
    """Strongly-connected-component condensation order (iterative Tarjan).

    Returns (nscc, order, rank, scc_id): nodes ordered so every SCC's
    members are consecutive and SCCs appear in condensation-topological
    order; on a DAG (nscc == n) this is a valid topological order.  The
    cyclic-graph analogue of the reference's component order
    (src/AlignmentGraph.cpp:1008-1115).
    """
    lib = get_lib()
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    order = np.empty(n, dtype=np.int64)
    rank = np.empty(n, dtype=np.int64)
    scc = np.empty(n, dtype=np.int64)
    nscc = lib.scc_order(ctypes.c_int64(n), ctypes.c_int64(len(src)),
                         _ptr(src), _ptr(dst), _ptr(order), _ptr(rank),
                         _ptr(scc))
    return int(nscc), order, rank, scc


def approx_pos(n: int, src: np.ndarray, dst: np.ndarray,
               node_len: np.ndarray) -> np.ndarray:
    """Longest-path-from-source coordinate per node (the reference's
    chainApproxPos analogue, src/AlignmentGraph.cpp:309-642)."""
    lib = get_lib()
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    node_len = np.ascontiguousarray(node_len, dtype=np.int64)
    pos = np.empty(n, dtype=np.int64)
    lib.approx_pos(ctypes.c_int64(n), ctypes.c_int64(len(src)),
                   _ptr(src), _ptr(dst), _ptr(node_len), _ptr(pos))
    return pos


def connected_components(n: int, src: np.ndarray, dst: np.ndarray):
    """Weakly connected components.  Returns (ncomp, comp_ids)."""
    lib = get_lib()
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    comp = np.empty(n, dtype=np.int64)
    ncomp = lib.connected_components(
        ctypes.c_int64(n), ctypes.c_int64(len(src)), _ptr(src), _ptr(dst),
        _ptr(comp))
    return int(ncomp), comp


def mpc_build(n: int, src: np.ndarray, dst: np.ndarray, comp: np.ndarray,
              ncomp: int):
    """Minimum path cover + last2reach index for a DAG.

    Returns a dict with:
      path_offsets (npaths+1,), path_nodes (flat), path_comp (npaths,),
      path_k (npaths,): per-component path index;
      back_offsets (n+1,), back_node (pairs,), back_k (pairs,):
        per-node last2reach pointers (u, k);
      nodepath_offsets (n+1,), nodepath_k (flat): path ids through each node.
    """
    lib = get_lib()
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    comp = np.ascontiguousarray(comp, dtype=np.int64)
    h = lib.mpc_build(ctypes.c_int64(n), ctypes.c_int64(len(src)), _ptr(src),
                      _ptr(dst), _ptr(comp), ctypes.c_int64(ncomp))
    if not h:
        raise ValueError("mpc_build failed (graph has a cycle?)")
    sizes = np.empty(4, dtype=np.int64)
    lib.mpc_sizes(h, _ptr(sizes))
    npaths, nnodes, npairs, nnp = (int(x) for x in sizes)
    path_offsets = np.empty(npaths + 1, dtype=np.int64)
    path_nodes = np.empty(nnodes, dtype=np.int64)
    path_comp = np.empty(npaths, dtype=np.int64)
    path_k = np.empty(npaths, dtype=np.int64)
    back_offsets = np.empty(n + 1, dtype=np.int64)
    back_data = np.empty(npairs * 2, dtype=np.int64)
    nodepath_offsets = np.empty(n + 1, dtype=np.int64)
    nodepath_k = np.empty(nnp, dtype=np.int64)
    lib.mpc_copy(h, _ptr(path_offsets), _ptr(path_nodes), _ptr(path_comp),
                 _ptr(path_k), _ptr(back_offsets), _ptr(back_data),
                 _ptr(nodepath_offsets), _ptr(nodepath_k))
    lib.mpc_free(h)
    back = back_data.reshape(-1, 2)
    return dict(path_offsets=path_offsets, path_nodes=path_nodes,
                path_comp=path_comp, path_k=path_k,
                back_offsets=back_offsets, back_node=back[:, 0].copy(),
                back_k=back[:, 1].copy(),
                nodepath_offsets=nodepath_offsets, nodepath_k=nodepath_k)


def band_build(n: int, ptr: np.ndarray, idx: np.ndarray,
               node_len: np.ndarray, seed_nodes: np.ndarray,
               seed_lens: np.ndarray, B: int, max_bp: int, max_in: int,
               descending: bool, by_dist: bool = False):
    """Per-seed DP band selection (see native band_build).  `ptr`/`idx` is
    the CSR of the traversal direction (out-edges for forward extension,
    in-edges for backward).  Returns (nodes [S,B], in_edges [S,B,max_in],
    levels [S,B], n_truncated), -1 padded, slot 0 = seed.  `levels` are
    band topo levels (the kernel's sequential depth); n_truncated > 0
    means some in-band in-edges were dropped by the max_in cap (scores
    may overestimate on those slots)."""
    lib = get_lib()
    ptr = np.ascontiguousarray(ptr, dtype=np.int64)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    node_len = np.ascontiguousarray(node_len, dtype=np.int64)
    seed_nodes = np.ascontiguousarray(seed_nodes, dtype=np.int64)
    seed_lens = np.ascontiguousarray(seed_lens, dtype=np.int64)
    ns = len(seed_nodes)
    out_nodes = np.empty(ns * B, dtype=np.int64)
    out_in = np.empty(ns * B * max_in, dtype=np.int64)
    out_level = np.empty(ns * B, dtype=np.int64)
    trunc = lib.band_build(
        ctypes.c_int64(n), _ptr(ptr), _ptr(idx), _ptr(node_len),
        ctypes.c_int64(ns), _ptr(seed_nodes), _ptr(seed_lens),
        ctypes.c_int64(B), ctypes.c_int64(max_bp),
        ctypes.c_int64(max_in), ctypes.c_int64(int(descending)),
        ctypes.c_int64(int(by_dist)),
        _ptr(out_nodes), _ptr(out_in), _ptr(out_level))
    return (out_nodes.reshape(ns, B),
            out_in.reshape(ns, B, max_in),
            out_level.reshape(ns, B), int(trunc))


def band_build_multi(n: int, ptr: np.ndarray, idx: np.ndarray,
                     node_len: np.ndarray, src_off: np.ndarray,
                     src_nodes: np.ndarray, B: int, max_bp: int,
                     max_in: int, descending: bool,
                     by_dist: bool = False):
    """Multi-source band build (full-band carry windows): job q's band is
    grown from src_nodes[src_off[q]:src_off[q+1]] all at distance 0.
    Returns (nodes [J,B], in_edges [J,B,max_in], levels [J,B],
    n_truncated), -1 padded."""
    lib = get_lib()
    ptr = np.ascontiguousarray(ptr, dtype=np.int64)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    node_len = np.ascontiguousarray(node_len, dtype=np.int64)
    src_off = np.ascontiguousarray(src_off, dtype=np.int64)
    src_nodes = np.ascontiguousarray(src_nodes, dtype=np.int64)
    nj = len(src_off) - 1
    out_nodes = np.empty(nj * B, dtype=np.int64)
    out_in = np.empty(nj * B * max_in, dtype=np.int64)
    out_level = np.empty(nj * B, dtype=np.int64)
    trunc = lib.band_build_multi(
        ctypes.c_int64(n), _ptr(ptr), _ptr(idx), _ptr(node_len),
        ctypes.c_int64(nj), _ptr(src_off), _ptr(src_nodes),
        ctypes.c_int64(B), ctypes.c_int64(max_bp),
        ctypes.c_int64(max_in), ctypes.c_int64(int(descending)),
        ctypes.c_int64(int(by_dist)),
        _ptr(out_nodes), _ptr(out_in), _ptr(out_level))
    return (out_nodes.reshape(nj, B),
            out_in.reshape(nj, B, max_in),
            out_level.reshape(nj, B), int(trunc))


def join_anchors(best_in: np.ndarray, best_slot: np.ndarray,
                 best_score: np.ndarray, best_col: np.ndarray,
                 end_slice: np.ndarray, band_nodes: np.ndarray,
                 node_len: np.ndarray, fi_fwd: np.ndarray,
                 fi_bwd: np.ndarray, seed_node: np.ndarray,
                 seed_off: np.ndarray, big: int):
    """Fused backwalk + fwd/bwd anchor join (one native pass over all
    fragment pairs; replaces the per-fragment extract_anchor Python).

    Returns (ok, score, first_node, first_off, last_node, last_off,
    path_offsets [nfrag+1], path_nodes flat) — joined consecutive-deduped
    split-node paths, empty where ok == 0."""
    lib = get_lib()
    if best_in.shape[1] > 127:
        raise ValueError(
            "native join_anchors is int8-indexed (B <= 127)")
    best_in = np.ascontiguousarray(best_in, dtype=np.int8)
    F, B, S = best_in.shape
    nfrag = len(fi_fwd)
    arrs = [np.ascontiguousarray(a, dtype=np.int64)
            for a in (best_slot, best_score, best_col, end_slice,
                      band_nodes, node_len, fi_fwd, fi_bwd, seed_node,
                      seed_off)]
    ok = np.empty(nfrag, dtype=np.int64)
    score = np.empty(nfrag, dtype=np.int64)
    first_node = np.empty(nfrag, dtype=np.int64)
    first_off = np.empty(nfrag, dtype=np.int64)
    last_node = np.empty(nfrag, dtype=np.int64)
    last_off = np.empty(nfrag, dtype=np.int64)
    i8p = ctypes.POINTER(ctypes.c_int8)
    h = lib.join_anchors(ctypes.c_int64(nfrag), ctypes.c_int64(F),
                         ctypes.c_int64(B), ctypes.c_int64(S),
                         best_in.ctypes.data_as(i8p),
                         *[_ptr(a) for a in arrs], ctypes.c_int64(big),
                         _ptr(ok), _ptr(score), _ptr(first_node),
                         _ptr(first_off), _ptr(last_node), _ptr(last_off))
    sizes = np.empty(2, dtype=np.int64)
    lib.paths_sizes(h, _ptr(sizes))
    nq, ndata = int(sizes[0]), int(sizes[1])
    offsets = np.empty(nq + 1, dtype=np.int64)
    data = np.empty(max(ndata, 1), dtype=np.int64)
    lib.paths_copy(h, _ptr(offsets), _ptr(data))
    lib.paths_free(h)
    return (ok, score, first_node, first_off, last_node, last_off,
            offsets, data)


def stitch_batch(gx, anch_off: np.ndarray, ax: np.ndarray, ay: np.ndarray,
                 first_node: np.ndarray, first_off: np.ndarray,
                 last_node: np.ndarray, last_off: np.ndarray,
                 path_off: np.ndarray, path_nodes: np.ndarray,
                 c_val: np.ndarray, c_pred: np.ndarray,
                 reads: list, colinear_gap: int):
    """Whole-batch best_chain + stitch + extend_tails in one native pass.

    gx: GraphTensors; anchors columnar, grouped by read (anch_off ragged
    offsets); c_val/c_pred: (nr, A) chain DP results; reads: list of read
    strings aligned with the rows.

    Returns (positions list [(n,2) int64 per read], n_chained, first_x,
    last_y, ok)."""
    lib = get_lib()
    if not hasattr(lib, "_stitch_sig"):
        _U8P = ctypes.POINTER(ctypes.c_uint8)
        lib.stitch_batch.restype = ctypes.c_void_p
        lib.stitch_batch.argtypes = (
            [ctypes.c_int64] + [_I64P] * 4 + [_I64P, _I64P, _U8P]
            + [_I64P] * 3 + [ctypes.c_int64] + [_I64P] * 9
            + [_I64P, _I64P, ctypes.c_int64, _U8P, _I64P,
               ctypes.c_int64] + [_I64P] * 4)
        lib._stitch_sig = True
    g = gx.g
    nr = len(anch_off) - 1
    read_bytes = np.frombuffer("".join(reads).encode("ascii"),
                               dtype=np.uint8)
    read_off = np.zeros(nr + 1, dtype=np.int64)
    np.cumsum([len(r) for r in reads], out=read_off[1:])
    a_stride = c_val.shape[1] if c_val.ndim == 2 else 0
    cv = np.ascontiguousarray(c_val, dtype=np.int64)
    cp = np.ascontiguousarray(c_pred, dtype=np.int64)
    i64 = lambda a: np.ascontiguousarray(a, dtype=np.int64)
    arrs = dict(
        out_ptr=gx.out_ptr, out_idx=gx.out_idx, in_ptr=gx.in_ptr,
        in_idx=gx.in_idx, node_len=gx.node_len64, comp=i64(g.comp),
        di_base=gx.di_base, orig_node=i64(g.orig_node),
        orig_offset=i64(g.orig_offset), anch_off=i64(anch_off),
        ax=i64(ax), ay=i64(ay), first_node=i64(first_node),
        first_off=i64(first_off), last_node=i64(last_node),
        last_off=i64(last_off), path_off=i64(path_off),
        path_nodes=i64(path_nodes))
    n_chained = np.empty(nr, dtype=np.int64)
    first_x = np.empty(nr, dtype=np.int64)
    last_y = np.empty(nr, dtype=np.int64)
    ok = np.empty(nr, dtype=np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    h = lib.stitch_batch(
        ctypes.c_int64(g.n_nodes), _ptr(arrs["out_ptr"]),
        _ptr(arrs["out_idx"]), _ptr(arrs["in_ptr"]), _ptr(arrs["in_idx"]),
        _ptr(arrs["node_len"]), _ptr(arrs["comp"]),
        gx.seq_bytes.ctypes.data_as(u8p), _ptr(arrs["di_base"]),
        _ptr(arrs["orig_node"]), _ptr(arrs["orig_offset"]),
        ctypes.c_int64(nr), _ptr(arrs["anch_off"]), _ptr(arrs["ax"]),
        _ptr(arrs["ay"]), _ptr(arrs["first_node"]),
        _ptr(arrs["first_off"]), _ptr(arrs["last_node"]),
        _ptr(arrs["last_off"]), _ptr(arrs["path_off"]),
        _ptr(arrs["path_nodes"]), _ptr(cv), _ptr(cp),
        ctypes.c_int64(a_stride),
        read_bytes.ctypes.data_as(u8p), _ptr(read_off),
        ctypes.c_int64(colinear_gap), _ptr(n_chained), _ptr(first_x),
        _ptr(last_y), _ptr(ok))
    sizes = np.empty(2, dtype=np.int64)
    lib.paths_sizes(h, _ptr(sizes))
    nq, ndata = int(sizes[0]), int(sizes[1])
    offsets = np.empty(nq + 1, dtype=np.int64)
    data = np.empty(max(ndata, 1), dtype=np.int64)
    lib.paths_copy(h, _ptr(offsets), _ptr(data))
    lib.paths_free(h)
    positions = [data[offsets[i]:offsets[i + 1]].reshape(-1, 2).copy()
                 for i in range(nq)]
    return positions, n_chained, first_x, last_y, ok


def find_chains(n: int, out_ptr: np.ndarray, out_idx: np.ndarray,
                in_ptr: np.ndarray, in_idx: np.ndarray,
                node_len: np.ndarray, di_ptr: np.ndarray,
                di_splits: np.ndarray, split_size: int = 32):
    """Chain decomposition + per-chain approximate positions (reference
    findChains / fixChainApproxPos, src/AlignmentGraph.cpp:309-642).
    Returns (chain_number [N] int64 union-find roots, chain_pos [N]
    int64)."""
    lib = get_lib()
    if not hasattr(lib, "_chains_sig"):
        lib.find_chains.restype = None
        lib.find_chains.argtypes = ([ctypes.c_int64] + [_I64P] * 5
                                    + [ctypes.c_int64, _I64P, _I64P,
                                       ctypes.c_int64, _I64P, _I64P])
        lib._chains_sig = True
    i64 = lambda a: np.ascontiguousarray(a, dtype=np.int64)
    op, oi, ip, ii = i64(out_ptr), i64(out_idx), i64(in_ptr), i64(in_idx)
    nl, dp, ds = i64(node_len), i64(di_ptr), i64(di_splits)
    chain = np.empty(n, dtype=np.int64)
    pos = np.empty(n, dtype=np.int64)
    lib.find_chains(ctypes.c_int64(n), _ptr(op), _ptr(oi), _ptr(ip),
                    _ptr(ii), _ptr(nl), ctypes.c_int64(len(dp) - 1),
                    _ptr(dp), _ptr(ds), ctypes.c_int64(split_size),
                    _ptr(chain), _ptr(pos))
    return chain, pos


def _alignment_args(gx, positions_list, ops_list, reads):
    """The graph and per-read alignment arguments that repair_batch and
    corridor_polish_batch share: the graph's tables, then each read's
    positions, ops and bases concatenated with their offsets (a read
    without positions or ops as an empty one).  The arrays stay alive
    with the pointers made from them (numpy's data_as keeps a reference).
    """
    g = gx.g
    nr = len(reads)
    pos_off = np.zeros(nr + 1, dtype=np.int64)
    ops_off = np.zeros(nr + 1, dtype=np.int64)
    read_off = np.zeros(nr + 1, dtype=np.int64)
    pos_parts, ops_parts = [], []
    for i in range(nr):
        p = positions_list[i]
        o = ops_list[i]
        if p is None or o is None or len(p) == 0:
            p = np.zeros((0, 2), dtype=np.int64)
            o = np.zeros(0, dtype=np.uint8)
        pos_parts.append(np.ascontiguousarray(p, dtype=np.int64))
        ops_parts.append(np.ascontiguousarray(o, dtype=np.uint8))
        pos_off[i + 1] = pos_off[i] + len(pos_parts[-1])
        ops_off[i + 1] = ops_off[i] + len(ops_parts[-1])
        read_off[i + 1] = read_off[i] + len(reads[i])
    pos_cat = (np.concatenate(pos_parts, axis=0) if pos_off[-1]
               else np.zeros((1, 2), dtype=np.int64))
    ops_cat = (np.concatenate(ops_parts) if ops_off[-1]
               else np.zeros(1, dtype=np.uint8))
    read_bytes = np.frombuffer("".join(reads).encode("ascii") or b"\0",
                               dtype=np.uint8)
    i64 = lambda a: _ptr(np.ascontiguousarray(a, dtype=np.int64))
    return (ctypes.c_int64(g.n_nodes), _ptr(gx.out_ptr), _ptr(gx.out_idx),
            _ptr(gx.in_ptr), _ptr(gx.in_idx), _ptr(gx.node_len64),
            gx.seq_bytes.ctypes.data_as(_U8P), i64(gx.di_base),
            i64(g.orig_node), i64(g.orig_offset), ctypes.c_int64(nr),
            _ptr(pos_off), i64(pos_cat[:, 0]), i64(pos_cat[:, 1]),
            _ptr(ops_off), ops_cat.ctypes.data_as(_U8P),
            read_bytes.ctypes.data_as(_U8P), _ptr(read_off))


def repair_batch(gx, positions_list, ops_list, reads, max_arm_len: int = 32):
    """Whole-batch polish-guided bubble repair: align/repair.repair_read
    in C++, one read after another (graphchainer_tpu/native.py's
    repair_batch).  positions_list: per read, (P, 2) int64 positions (or
    None / empty); ops_list: per read, the polish ops (or None); reads:
    the read strings.  Returns a list of repaired (n, 2) arrays (None =
    no change)."""
    lib = get_lib()
    if not hasattr(lib, "_repair_sig"):
        lib.repair_batch.restype = ctypes.c_void_p
        lib.repair_batch.argtypes = (
            [ctypes.c_int64] + [_I64P] * 5 + [_U8P] + [_I64P] * 3
            + [ctypes.c_int64] + [_I64P] * 4 + [_U8P, _U8P, _I64P]
            + [ctypes.c_int64, _I64P])
        lib._repair_sig = True
    nr = len(reads)
    changed = np.zeros(nr, dtype=np.int64)
    h = lib.repair_batch(
        *_alignment_args(gx, positions_list, ops_list, reads),
        ctypes.c_int64(max_arm_len), _ptr(changed))
    sizes = np.empty(2, dtype=np.int64)
    lib.paths_sizes(h, _ptr(sizes))
    nq, ndata = int(sizes[0]), int(sizes[1])
    offsets = np.empty(nq + 1, dtype=np.int64)
    data = np.empty(max(ndata, 1), dtype=np.int64)
    lib.paths_copy(h, _ptr(offsets), _ptr(data))
    lib.paths_free(h)
    return [data[offsets[i]:offsets[i + 1]].reshape(-1, 2).copy()
            if changed[i] else None for i in range(nr)]


def corridor_polish_batch(gx, positions_list, ops_list, reads, scores,
                          band: int = 48, max_arm_len: int = 64):
    """Exact banded DP over each read's path-corridor DAG (path + 1-hop
    sibling/skip/insertion arms), with per-cell backtrace — resolves all
    the bubble-arm choices jointly, unlike the local repair_batch.  The
    C++ kernel documents the rationale (the word-granular device
    backwalk can emit a path that misses the banded-optimal score; the
    reference's per-cell backtrace never does,
    src/GraphAlignerBitvectorCommon.h:392-544).

    positions_list/ops_list/reads/scores: per-read current alignment.
    Returns a list of (score, positions (n,2), ops uint8) tuples, or
    None where the corridor found nothing strictly better."""
    lib = get_lib()
    if not hasattr(lib, "_corridor_sig"):
        lib.corridor_polish_batch.restype = ctypes.c_void_p
        lib.corridor_polish_batch.argtypes = (
            [ctypes.c_int64] + [_I64P] * 5 + [_U8P] + [_I64P] * 3
            + [ctypes.c_int64] + [_I64P] * 4 + [_U8P, _U8P, _I64P]
            + [_I64P, ctypes.c_int64, ctypes.c_int64])
        lib.corridor_sizes.argtypes = [ctypes.c_void_p, _I64P]
        lib.corridor_copy.argtypes = [ctypes.c_void_p, _I64P, _I64P,
                                      _I64P, _U8P, _I64P]
        lib.corridor_free.argtypes = [ctypes.c_void_p]
        lib._corridor_sig = True
    cur = np.ascontiguousarray([int(s) for s in scores], dtype=np.int64)
    h = lib.corridor_polish_batch(
        *_alignment_args(gx, positions_list, ops_list, reads), _ptr(cur),
        ctypes.c_int64(band), ctypes.c_int64(max_arm_len))
    sizes = np.empty(3, dtype=np.int64)
    lib.corridor_sizes(h, _ptr(sizes))
    nq, npos, nops = int(sizes[0]), int(sizes[1]), int(sizes[2])
    pos_offsets = np.empty(nq + 1, dtype=np.int64)
    pos_data = np.empty(max(npos, 1), dtype=np.int64)
    ops_offsets = np.empty(nq + 1, dtype=np.int64)
    ops_data = np.empty(max(nops, 1), dtype=np.uint8)
    new_scores = np.empty(nq, dtype=np.int64)
    lib.corridor_copy(h, _ptr(pos_offsets), _ptr(pos_data),
                      _ptr(ops_offsets), ops_data.ctypes.data_as(_U8P),
                      _ptr(new_scores))
    lib.corridor_free(h)
    out = []
    for i in range(nq):
        if new_scores[i] < 0:
            out.append(None)
        else:
            out.append((int(new_scores[i]),
                        pos_data[pos_offsets[i]:pos_offsets[i + 1]]
                        .reshape(-1, 2).copy(),
                        ops_data[ops_offsets[i]:ops_offsets[i + 1]]
                        .copy()))
    return out


def seed_window_batch(index, gx, reads, density: float, flen: int,
                      sep: int, kper: int):
    """The CLC seed+window stage in one native call: minimizer seeds and
    fragment windows for a batch.  Releases the GIL for its whole
    duration, so concurrent pipeline workers overlap instead of
    serializing on the interpreter lock.

    index: MinimizerIndex; gx: GraphTensors; reads: list of (name, seq).
    Returns (JobCols, frags [nfrag,7] int64 rows of (read_idx, l, r,
    fi_fwd, fi_bwd, seed split, seed off), seed_counts list)."""
    lib = get_lib()
    if not hasattr(lib, "_sw_sig"):
        _U8P = ctypes.POINTER(ctypes.c_uint8)
        lib.seed_window_batch.restype = ctypes.c_void_p
        lib.seed_window_batch.argtypes = (
            [ctypes.c_int64, _I64P, _I64P, _I64P]
            + [ctypes.c_int64] * 3 + [ctypes.c_double]
            + [ctypes.c_int64, _U8P, _I64P]
            + [ctypes.c_int64] + [_I64P] * 4
            + [ctypes.c_int64] * 3 + [_I64P])
        lib.sw_sizes.argtypes = [ctypes.c_void_p, _I64P]
        lib.sw_copy.argtypes = [ctypes.c_void_p] + [_I64P] * 7
        lib.sw_free.argtypes = [ctypes.c_void_p]
        lib._sw_sig = True
    # index arrays (cached int64 copies live on the index object: the
    # same index serves every batch)
    cache = getattr(index, "_native_arrs", None)
    if cache is None:
        cache = (np.ascontiguousarray(index.codes).view(np.int64),
                 np.ascontiguousarray(index.di_node, dtype=np.int64),
                 np.ascontiguousarray(index.offset, dtype=np.int64))
        index._native_arrs = cache
    codes_i64, di_node, offset = cache
    split_keys, split_vals = gx.split_lookup()
    nr = len(reads)
    read_bytes = np.frombuffer("".join(s for _, s in reads).encode("ascii")
                               or b"\0", dtype=np.uint8)
    read_off = np.zeros(nr + 1, dtype=np.int64)
    np.cumsum([len(s) for _, s in reads], out=read_off[1:])
    seed_counts = np.zeros(nr, dtype=np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    orig_offset = gx.orig_offset64
    h = lib.seed_window_batch(
        ctypes.c_int64(len(codes_i64)), _ptr(codes_i64), _ptr(di_node),
        _ptr(offset), ctypes.c_int64(int(index.count_cap)),
        ctypes.c_int64(int(index.k)), ctypes.c_int64(int(index.w)),
        ctypes.c_double(float(density)),
        ctypes.c_int64(nr), read_bytes.ctypes.data_as(u8p), _ptr(read_off),
        ctypes.c_int64(len(split_keys)), _ptr(split_keys),
        _ptr(split_vals), _ptr(gx.node_len64), _ptr(orig_offset),
        ctypes.c_int64(flen), ctypes.c_int64(sep), ctypes.c_int64(kper),
        _ptr(seed_counts))
    sizes = np.empty(2, dtype=np.int64)
    lib.sw_sizes(h, _ptr(sizes))
    F, nfrag = int(sizes[0]), int(sizes[1])
    seed = np.empty(max(F, 1), dtype=np.int64)
    trim = np.empty(max(F, 1), dtype=np.int64)
    rev = np.empty(max(F, 1), dtype=np.int64)
    read_idx = np.empty(max(F, 1), dtype=np.int64)
    lo = np.empty(max(F, 1), dtype=np.int64)
    hi = np.empty(max(F, 1), dtype=np.int64)
    frags = np.empty(max(nfrag * 7, 1), dtype=np.int64)
    lib.sw_copy(h, _ptr(seed), _ptr(trim), _ptr(rev), _ptr(read_idx),
                _ptr(lo), _ptr(hi), _ptr(frags))
    lib.sw_free(h)
    jc = JobCols(seed=seed[:F], trim=trim[:F],
                 rev=rev[:F].astype(bool), read_idx=read_idx[:F],
                 lo=lo[:F], hi=hi[:F])
    return jc, frags[:nfrag * 7].reshape(nfrag, 7), seed_counts.tolist()


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array of a uint8 text (prefix doubling, offline build)."""
    lib = get_lib()
    text = np.ascontiguousarray(text, dtype=np.uint8)
    sa = np.empty(len(text), dtype=np.int64)
    lib.suffix_array(text.ctypes.data_as(_U8P), ctypes.c_int64(len(text)),
                     _ptr(sa))
    return sa


def matching_stats(text: np.ndarray, sa: np.ndarray, read: np.ndarray):
    """Per read position: (longest match length, SA interval lo, hi)."""
    lib = get_lib()
    text = np.ascontiguousarray(text, dtype=np.uint8)
    sa = np.ascontiguousarray(sa, dtype=np.int64)
    read = np.ascontiguousarray(read, dtype=np.uint8)
    m = len(read)
    ms_len = np.empty(m, dtype=np.int64)
    ms_lo = np.empty(m, dtype=np.int64)
    ms_hi = np.empty(m, dtype=np.int64)
    lib.matching_stats(text.ctypes.data_as(_U8P), ctypes.c_int64(len(text)),
                       _ptr(sa), read.ctypes.data_as(_U8P),
                       ctypes.c_int64(m), _ptr(ms_len), _ptr(ms_lo),
                       _ptr(ms_hi))
    return ms_len, ms_lo, ms_hi


def minimizer_build(seq_bytes: np.ndarray, seq_off: np.ndarray, k: int,
                    w: int, n_threads: int = 0):
    """Whole-graph minimizer extraction + stable code sort in native
    threads (bit-identical to the NumPy build_index path).
    Returns (codes uint64 sorted, node int64, off int64)."""
    lib = get_lib()
    if not hasattr(lib, "_mb_sig"):
        _U8P = ctypes.POINTER(ctypes.c_uint8)
        lib.minimizer_build.restype = ctypes.c_void_p
        lib.minimizer_build.argtypes = [_U8P, _I64P] + \
            [ctypes.c_int64] * 4
        lib.mb_sizes.argtypes = [ctypes.c_void_p, _I64P]
        lib.mb_copy.argtypes = [ctypes.c_void_p] + [_I64P] * 3
        lib.mb_free.argtypes = [ctypes.c_void_p]
        lib._mb_sig = True
    if not n_threads:
        try:
            n_threads = len(os.sched_getaffinity(0))
        except (AttributeError, OSError):
            n_threads = os.cpu_count() or 4
    seq_bytes = np.ascontiguousarray(seq_bytes, dtype=np.uint8)
    seq_off = np.ascontiguousarray(seq_off, dtype=np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    h = lib.minimizer_build(seq_bytes.ctypes.data_as(u8p), _ptr(seq_off),
                            ctypes.c_int64(len(seq_off) - 1),
                            ctypes.c_int64(k), ctypes.c_int64(w),
                            ctypes.c_int64(n_threads))
    sizes = np.empty(1, dtype=np.int64)
    lib.mb_sizes(h, _ptr(sizes))
    n = int(sizes[0])
    codes = np.empty(max(n, 1), dtype=np.int64)
    node = np.empty(max(n, 1), dtype=np.int64)
    off = np.empty(max(n, 1), dtype=np.int64)
    lib.mb_copy(h, _ptr(codes), _ptr(node), _ptr(off))
    lib.mb_free(h)
    return codes[:n].view(np.uint64), node[:n], off[:n]
