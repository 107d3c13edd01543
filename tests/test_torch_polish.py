"""The polish stage of graphchainer_torch vs graphchainer_tpu: the band
fill _polish_core_t, _score_from_dump_t, _backtrace_t and polish_batch
with its band ramp — exact equality on the same numpy inputs (the JAX
side runs its XLA core, which tests/test_pallas_polish.py pins to the
Pallas kernel), and the native host polish."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from graphchainer_tpu.align import polish as JP
from graphchainer_tpu.ops import linear_align as JL
from graphchainer_torch.align import polish as TP
from graphchainer_torch.ops import linear_align as TL

from graphchainer_torch.workload import polish_hard_pairs

from test_torch_common import (load_fixture, mixed_batch,
                               pack_polish_pairs, t64)


@pytest.mark.parametrize("bw", [4, 8])
def test_polish_core_score_backtrace_match_jax(bw):
    planes_t, path_t, rl, pl = mixed_batch()
    J = [jnp.asarray(a) for a in (planes_t, path_t, rl, pl)]
    T = [t64(a) for a in (planes_t, path_t, rl, pl)]
    ref = JL._polish_core_t(*J, bw)
    got = TL._polish_core_t(*T, bw)
    for name, r, g in zip(("vp", "vn", "sb", "base"), ref, got):
        r = np.asarray(r).astype(np.int64)
        np.testing.assert_array_equal(r, g.numpy(), err_msg=name)
    np.testing.assert_array_equal(
        np.asarray(JL._score_from_dump_t(*ref, J[2], J[3], bw)),
        TL._score_from_dump_t(*got, T[2], T[3], bw).numpy())
    for max_steps, cap in ((1024, 512), (1024, 256)):
        rb = JL._backtrace_t(*ref, J[0], J[1], J[2], J[3], bw, max_steps,
                             cap)
        gb = TL._backtrace_t(*got, T[0], T[1], T[2], T[3], bw, max_steps,
                             cap)
        np.testing.assert_array_equal(np.asarray(rb.ops_rev),
                                      gb.ops_rev.numpy())
        np.testing.assert_array_equal(np.asarray(rb.n_ops), gb.n_ops.numpy())
        np.testing.assert_array_equal(np.asarray(rb.touched),
                                      gb.touched.numpy())
    # the short cap makes some walks overflow (n_ops == -1)
    assert (gb.n_ops.numpy() == -1).any() and (gb.n_ops.numpy() > 0).any()


@pytest.mark.parametrize("bw", [8, 16])
def test_polish_hard_cases_match_jax(bw):
    """The inputs the warp-per-read kernels must survive, through the
    plain versions and the JAX functions: a batch that mixes bands moving
    several words a column (the kernels' serial branch) with ordinary
    reads, a path far below the padded column count, an empty read and an
    empty path, walks along a band edge, and walks that overflow a short
    ops_cap.  The smoke run holds the kernels to the plain versions on
    the same generator's pairs at full size."""
    trip = polish_hard_pairs(5, 3, 700, indel=200)
    labels = [lab for lab, _, _ in trip]
    A = pack_polish_pairs([(r, p) for _, r, p in trip], 1024, 896)
    J = [jnp.asarray(a) for a in A]
    T = [t64(a) for a in A]
    ref = JL._polish_core_t(*J, bw)
    got = TL._polish_core_t(*T, bw)
    for name, r, g in zip(("vp", "vn", "sb", "base"), ref, got):
        np.testing.assert_array_equal(np.asarray(r).astype(np.int64),
                                      g.numpy(), err_msg=name)
    # the band of the multi_shift read moves two words in some column,
    # that of the plain reads never more than one
    step = np.diff(got[3].numpy(), axis=0).max(axis=0)
    assert step[labels.index("multi_shift")] >= 2
    assert all(step[i] <= 1 for i, lab in enumerate(labels)
               if lab.startswith("plain"))
    np.testing.assert_array_equal(
        np.asarray(JL._score_from_dump_t(*ref, J[2], J[3], bw)),
        TL._score_from_dump_t(*got, T[2], T[3], bw).numpy())
    for cap in (0, 672):
        rb = JL._backtrace_t(*ref, *J, bw, 1920, cap)
        gb = TL._backtrace_t(*got, *T, bw, 1920, cap)
        np.testing.assert_array_equal(np.asarray(rb.ops_rev),
                                      gb.ops_rev.numpy())
        np.testing.assert_array_equal(np.asarray(rb.n_ops), gb.n_ops.numpy())
        np.testing.assert_array_equal(np.asarray(rb.touched),
                                      gb.touched.numpy())
        n_ops = dict(zip(labels, gb.n_ops.tolist()))
        touched = dict(zip(labels, gb.touched.tolist()))
        assert n_ops["empty_read"] == n_ops["empty_path"] == -1
        assert touched["multi_shift"] and not touched["plain0"]
        assert touched["deletion"] == (bw == 8)
        if cap:     # the longer walks overflow, the shorter complete
            assert n_ops["plain2"] > 0 and n_ops["insertion"] == -1
        else:
            assert n_ops["insertion"] == 900 and n_ops["deletion"] == 700
    packed = TL._polish_walk_t(*got, *T, bw, 1920, 672)
    np.testing.assert_array_equal(packed[:, 1].numpy(), gb.n_ops.numpy())


def polish_case():
    """Reads vs paths: plain 10%-error reads, one with a 160 bp deletion
    that leaves a narrow band (the ramp retries it wider) and one whose
    path is far shorter than the read."""
    rng = np.random.default_rng(11)
    reads, paths = [], []
    for i in range(6):
        p = "".join(rng.choice(list("ACGT"), int(rng.integers(300, 700))))
        r = list(p)
        for _ in range(len(p) // 10):
            j = int(rng.integers(0, len(r)))
            op = int(rng.integers(0, 3))
            if op == 0:
                r[j] = str(rng.choice(list("ACGT")))
            elif op == 1:
                del r[j]
            else:
                r.insert(j, str(rng.choice(list("ACGT"))))
        reads.append("".join(r))
        paths.append(p)
    p = paths[0]
    reads.append(p[:200] + p[360:])
    paths.append(p)
    reads.append(paths[1])
    paths.append(paths[1][:60])
    return reads, paths


def same(a, b):
    assert a.score == b.score and a.touched == b.touched
    assert (a.ops is None) == (b.ops is None)
    if a.ops is not None:
        np.testing.assert_array_equal(a.ops, b.ops)


def test_polish_batch_matches_jax_and_host():
    reads, paths = polish_case()
    got = TP.polish_batch(reads, paths, bw=4, device="cpu")
    ref = JP.polish_batch(reads, paths, bw=4)
    host = JP.polish_batch_host(reads, paths, bw=4)
    for a, b, c in zip(ref, got, host):
        same(a, b)
        same(c, b)
    # the deletion read needed the ramp: at bw=4 alone it fails or
    # touches the band edge
    first = TP._polish_once(reads[-2:-1], paths[-2:-1], 4, None, "cpu")[0]
    assert first.ops is None or first.touched


def test_polish_batch_table_and_iupac():
    """The per-batch read table gives the same outcomes as packing the
    reads; reads with IUPAC bases take the 4-bit path, which equals the
    native host polish."""
    reads, paths = polish_case()
    tbl = TP.build_read_table(reads, "cpu")
    assert tbl is not None
    rows = np.array([7, 6, 3, 0])      # short path, ramp read, shuffled
    got = TP.polish_batch([reads[i] for i in rows], [paths[i] for i in rows],
                          bw=8, table=(tbl, rows), device="cpu")
    plain = TP.polish_batch([reads[i] for i in rows],
                            [paths[i] for i in rows], bw=8, device="cpu")
    for a, b in zip(plain, got):
        same(a, b)
    iupac = [r[:50] + "N" + r[51:120] + "R" + r[121:] for r in reads[:3]]
    assert TP.build_read_table(iupac, "cpu") is None
    got = TP.polish_batch(iupac, paths[:3], bw=8, device="cpu")
    host = JP.polish_batch_host(iupac, paths[:3], bw=8)
    for a, b in zip(host, got):
        same(a, b)


@pytest.mark.parametrize("fmt,bw", [("codes2", 4), ("nibbles", 8)])
def test_polish_full_packed_matches_jax(fmt, bw):
    """The fill + walk + op packing front ends equal the JAX package's
    packed rows (its ops words are int32 bit patterns)."""
    reads, paths = polish_case()
    rl = np.array([len(r) for r in reads], np.int32)
    pl = np.array([len(p) for p in paths], np.int32)
    pack = TP.pack_codes2 if fmt == "codes2" else TP.pack_nibbles
    rw = pack(TP._pack_rows(reads, rl, 1024))
    pw = pack(TP._pack_rows(paths, pl, 1024))
    jf, tf = ((JL.polish_full_packed2, TL.polish_full_packed2)
              if fmt == "codes2" else
              (JL.polish_full_packed, TL.polish_full_packed))
    cap = TP._ops_cap(1024, 1024, bw)
    ref = np.asarray(jf(jnp.asarray(rw), jnp.asarray(pw), jnp.asarray(rl),
                        jnp.asarray(pl), bw, max_steps=2048, ops_cap=cap))
    got = tf(t64(rw), t64(pw), t64(rl), t64(pl), bw, max_steps=2048,
             ops_cap=cap).numpy()
    np.testing.assert_array_equal(ref[:, :3], got[:, :3])
    np.testing.assert_array_equal(ref[:, 3:].astype(np.int64) & 0xFFFFFFFF,
                                  got[:, 3:])
    assert (got[:, 1] > 0).any()


def test_packed_formats_match_jax():
    rng = np.random.default_rng(3)
    mm = (np.uint8(1) << rng.integers(0, 4, size=(3, 64)).astype(np.uint8))
    c2 = TP.pack_codes2(mm)
    np.testing.assert_array_equal(c2, JP.pack_codes2(mm))
    mm4 = rng.integers(0, 16, size=(3, 64)).astype(np.uint8)
    p4 = TP.pack_nibbles(mm4)
    np.testing.assert_array_equal(p4, JP.pack_nibbles(mm4))
    for tf, jf, x in ((TL.expand_planes2, JL.expand_planes2, c2),
                      (TL.expand_codes2, JL.expand_codes2, c2),
                      (TL.expand_planes, JL.expand_planes, p4),
                      (TL.expand_nibbles, JL.expand_nibbles, p4)):
        np.testing.assert_array_equal(
            np.asarray(jf(jnp.asarray(x))).astype(np.int64),
            tf(t64(x)).numpy().astype(np.int64))
    ops = rng.integers(0, 4, size=(2, 64)).astype(np.uint8)
    np.testing.assert_array_equal(
        np.asarray(JL.pack_ops2(jnp.asarray(ops))).astype(np.int64),
        TL.pack_ops2(t64(ops).to(torch.uint8)).numpy())
    for r, p, b in ((3000, 4000, 8), (1024, 1024, 32), (500, 9000, 4)):
        assert TP._ops_cap(r, p, b) == JP._ops_cap(r, p, b)
        assert TP._round_up(r, 1024) == JP._round_up(r, 1024)


ANY_BANDS = (3, 12, 48)      # a --polish-band start of 3 ramps through 12
                             # and 48, one of 12 through 48


def any_band_case():
    """A 600 bp read with every 9th base substituted, against the 700 bp
    path it was cut from (and 50 bases on each side), and its first 300
    bases against the same path: reads whose polish needs a wide band or
    the ramp."""
    rng = np.random.default_rng(9)
    path = "".join(rng.choice(list("ACGT"), 700))
    read = list(path[50:650])
    for i in range(0, len(read), 9):
        read[i] = "ACGT"[("ACGT".index(read[i]) + 1 + int(rng.integers(3)))
                         % 4]
    read = "".join(read)
    return [read, read[:300]], [path, path]


def outcome_record(o) -> dict:
    """A PolishOutcome as JSON values."""
    return dict(score=int(o.score), touched=bool(o.touched),
                ops=None if o.ops is None else o.ops.astype(int).tolist())


@pytest.mark.parametrize("bw", ANY_BANDS)
def test_polish_batch_any_band_matches_jax(bw):
    """polish_batch from a start of any band width (the run-time-bw
    entries' widths) equals the JAX package's scores and ops (recorded)."""
    reads, paths = any_band_case()
    got = TP.polish_batch(reads, paths, bw=bw, device="cpu")
    want = load_fixture("polish_any_band")[str(bw)]
    assert [outcome_record(o) for o in got] == want
    assert all(w["ops"] is not None for w in want)
