"""The word tricks of csrc/frag_wide.cu's merges (ops/word_merge.py, the
same steps in torch) against the row-by-row min of row scores: random
words, hypothesis cases, the X / I sentinels, boundaries near BIG, all-ones
and all-zeros words; the free-start merge's closed form; and the slice-0
fold (a free-start merge after a column that already lies on or below the
free start gives back the column advanced with hin 0).  And the carried
entry of csrc/frag_core.cu, a lane a row: its column-0 merge against the
plain version's 33-row merge, its X scan against the row loop, and its
columns split at the slot's length against all 31 run at once."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from graphchainer_torch.ops.frag_align import BIG, _MergeAcc
from graphchainer_torch.ops.myers import (MASK32, ONES, W, advance_word,
                                          popcount32)
from graphchainer_torch.ops.word_merge import (free_start_word,
                                               merge_free_start,
                                               merge_words_lanes,
                                               merge_words_rows,
                                               merge_words_swar,
                                               split_columns, whole_columns,
                                               x_scan_lanes, x_scan_rows)

def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.int64))


def _words(rng, n, density=0.5):
    """n words with disjoint +1 / -1 bits."""
    vp = rng.integers(0, 1 << 32, n, dtype=np.int64)
    vn = rng.integers(0, 1 << 32, n, dtype=np.int64) & ~vp & MASK32
    keep = rng.random((n, 32)) < density
    mask = (keep * (1 << np.arange(32, dtype=np.int64))).sum(1)
    return vp & mask, vn & mask


def _similar(rng, vp, vn, flips):
    """Each word with `flips` random rows set to a random step."""
    vp, vn = vp.copy(), vn.copy()
    for _ in range(flips):
        r = rng.integers(0, 32, len(vp))
        step = rng.integers(-1, 2, len(vp))
        bit = np.int64(1) << r
        vp = np.where(step == 1, vp | bit, vp & ~bit)
        vn = np.where(step == -1, vn | bit, vn & ~bit)
    return vp, vn


def _check_merge(avp, avn, ba, bvp, bvn, bb):
    args = [_t(x) for x in (avp, avn, ba, bvp, bvn, bb)]
    want = merge_words_rows(*args)
    got = merge_words_swar(*args)
    for name, g, w in zip(("vp", "vn", "sb", "boundary"), got, want):
        bad = torch.nonzero(g != w).flatten()
        assert bad.numel() == 0, (
            f"{name} differs at {bad[:5].tolist()}: a="
            f"{[hex(int(args[0][i])) for i in bad[:1]]}")


@pytest.mark.parametrize("seed", range(4))
def test_merge_random_words(seed):
    rng = np.random.default_rng(seed)
    n = 4000
    avp, avn = _words(rng, n, density=rng.uniform(0.2, 1.0))
    bvp, bvn = _words(rng, n, density=rng.uniform(0.2, 1.0))
    ba = rng.integers(-40, 40, n)
    bb = ba + rng.integers(-70, 71, n)
    _check_merge(avp, avn, ba, bvp, bvn, bb)


@pytest.mark.parametrize("flips", [1, 3, 8])
def test_merge_similar_words(flips):
    """Words a few rows apart, boundaries within a few: the pairs whose
    scores cross, where the byte lanes decide."""
    rng = np.random.default_rng(100 + flips)
    n = 4000
    avp, avn = _words(rng, n)
    bvp, bvn = _similar(rng, avp, avn, flips)
    ba = rng.integers(0, 1000, n)
    bb = ba + rng.integers(-3, 4, n)
    _check_merge(avp, avn, ba, bvp, bvn, bb)


def test_merge_sentinels_and_extremes():
    X = (ONES, 0, BIG - W)            # the invalid word, boundary BIG - 32
    I = (0, 0, BIG)                   # the empty merge's start
    words = [X, I, (ONES, 0, 0), (0, ONES, 64), (0, 0, 5),
             (ONES, 0, BIG - 64), (0, ONES, BIG), (0x55555555, 0xAAAAAAAA, 3),
             (0xAAAAAAAA, 0x55555555, 3), (0xFFFF0000, 0x0000FFFF, BIG - 40),
             (0x0000FFFF, 0xFFFF0000, BIG - 40), (ONES, 0, BIG - 33)]
    a = [w for w in words for _ in words]
    b = [w for _ in words for w in words]
    _check_merge(*zip(*[(x[0], x[1], x[2], y[0], y[1], y[2])
                        for x, y in zip(a, b)]))


_word = st.tuples(st.integers(0, MASK32), st.integers(0, MASK32))


@settings(max_examples=400, deadline=None, database=None)
@given(a=_word, b=_word, ba=st.integers(-100, 100), d=st.integers(-80, 80))
def test_merge_hypothesis(a, b, ba, d):
    """Any words, overlapping bits too (a row with both bits set moves by
    0, as in the row-by-row loop)."""
    _check_merge([a[0]], [a[1]], [ba], [b[0]], [b[1]], [ba + d])


def test_free_start_word_rows():
    """The free-start word scores fbase + r + 1 - [a match in rows 0..r]
    on row r and fbase + hin at its boundary, for any match bits."""
    rng = np.random.default_rng(5)
    eq = _t(rng.integers(0, 1 << 32, 2000, dtype=np.int64))
    eq[:3] = torch.tensor([0, 1, 1 << 31])
    fbase = _t(rng.integers(-5, 300, 2000))
    for hin in (0, 1):
        vp, vn, sb, fb = free_start_word(eq, fbase, hin)
        assert torch.equal(sb - popcount32(vp) + popcount32(vn), fb)
        seen = torch.zeros_like(eq)
        score = fb.clone()
        for r in range(W):
            seen = seen | ((eq >> r) & 1)
            score = score + ((vp >> r) & 1) - ((vn >> r) & 1)
            assert torch.equal(score, fbase + r + 1 - seen)


def _check_free(vp, vn, wb, eq, fbase, hin):
    args = [_t(x) for x in (vp, vn, wb, eq, fbase)]
    fvp, fvn, _, fb = free_start_word(args[3], args[4], hin)
    want = merge_words_rows(args[0], args[1], args[2], fvp, fvn, fb)
    got = merge_free_start(*args, hin)
    for name, g, w in zip(("vp", "vn", "sb", "boundary"), got, want):
        bad = torch.nonzero(g != w).flatten()
        assert bad.numel() == 0, f"{name} differs at {bad[:5].tolist()}"


@pytest.mark.parametrize("hin", [0, 1])
def test_free_start_merge_closed_form(hin):
    rng = np.random.default_rng(7 + hin)
    n = 6000
    vp, vn = _words(rng, n, density=rng.uniform(0.3, 1.0))
    fbase = rng.integers(0, 2000, n)
    wb = fbase + rng.integers(-40, 70, n)
    eq = rng.integers(0, 1 << 32, n, dtype=np.int64)
    eq[: n // 4] &= rng.integers(0, 1 << 32, n // 4, dtype=np.int64)
    eq[n // 4: n // 3] = 0
    eq[n // 3: n // 2] = 1 << rng.integers(0, 32, n // 2 - n // 3)
    _check_free(vp, vn, wb, eq, fbase, hin)


@settings(max_examples=300, deadline=None, database=None)
@given(w=_word, eq=st.integers(0, MASK32), c0=st.integers(-70, 70),
       hin=st.sampled_from([0, 1]))
def test_free_start_merge_hypothesis(w, eq, c0, hin):
    vp, vn = w[0], w[1] & ~w[0]
    fbase = 1000
    _check_free([vp], [vn], [fbase - 1 + c0], [eq], [fbase], hin)


def test_free_start_merge_near_big():
    fbase = BIG - 400
    rng = np.random.default_rng(11)
    vp, vn = _words(rng, 500)
    vp[:2], vn[:2] = ONES, 0
    wb = np.full(500, BIG - W)
    eq = rng.integers(0, 1 << 32, 500, dtype=np.int64)
    _check_free(vp, vn, wb, eq, np.full(500, fbase), 1)


def test_slice0_fold():
    """At slice 0 a column whose boundary is the free start's (fbase) and
    whose rows lie on or below the free start's: advanced with hin 1 and
    merged with the next column's free-start word, it is the column
    advanced with hin 0 (the kernel's columns 2.. of slice 0)."""
    rng = np.random.default_rng(13)
    n = 6000
    vp, vn = _words(rng, n)
    base = _t(rng.integers(0, 500, n))
    # any column with a boundary at or above base, merged with a free
    # start: boundary base, rows on or below base + r + 1
    wb = base + _t(rng.integers(0, 40, n))
    f0 = free_start_word(_t(rng.integers(0, 1 << 32, n, dtype=np.int64)),
                         base, 0)
    mvp, mvn, msb, mb = merge_words_rows(_t(vp), _t(vn), wb, f0[0], f0[1],
                                          f0[3])
    assert torch.equal(mb, base)
    eq = _t(rng.integers(0, 1 << 32, n, dtype=np.int64))
    eq[:500] = 0
    avp, avn, asb, h1 = advance_word(mvp, mvn, msb, eq, 1)
    got = merge_free_start(avp, avn, base + 1, eq, base, 0)
    fvp, fvn, fsb, h0 = advance_word(mvp, mvn, msb, eq, 0)
    assert torch.equal(h0, h1)
    for g, w in zip(got, (fvp, fvn, fsb, base)):
        assert torch.equal(g, w)


def test_slice0_seed_word_is_dominated():
    """At slice 0 an in-edge's word (its predecessor's end word, boundary at
    most base, advanced with hin 1) lies on or below the seed word (the
    all-insertion column of bottom score base + 32 advanced with hin 1) on
    every row, and its boundary is at most the seed word's: their merge is
    the in-edge's word (the kernel's source test at column 0)."""
    rng = np.random.default_rng(17)
    n = 6000
    vp, vn = _words(rng, n)
    base = _t(rng.integers(0, 500, n))
    bp = base - _t(rng.integers(0, 3, n))          # the end word's boundary
    sb = bp + popcount32(_t(vp)) - popcount32(_t(vn))
    eq = _t(rng.integers(0, 1 << 32, n, dtype=np.int64))
    eq[:300] = 0
    evp, evn, esb, _ = advance_word(_t(vp), _t(vn), sb, eq, 1)
    svp, svn, ssb_, sbound = free_start_word(eq, base, 1)
    eb = esb - popcount32(evp) + popcount32(evn)
    assert bool((eb <= sbound).all())
    got = merge_words_rows(svp, svn, sbound, evp, evn, eb)
    for g, w in zip(got, (evp, evn, esb, eb)):
        assert torch.equal(g, w)


def _candidates(rng, n_words, n):
    """n_words candidate words of n lanes each, as the carried kernel's
    column 0 meets them: words at nearby boundaries, a few far above, and
    the sentinels (ONES, 0, BIG) and (ONES, 0, BIG + 32)."""
    base = rng.integers(-50, 3000, n)
    out = []
    for _ in range(n_words):
        vp, vn = _words(rng, n, density=rng.uniform(0.3, 1.0))
        sb = base + rng.integers(-40, 41, n)
        kind = rng.random(n)
        sb = np.where(kind < 0.05, BIG - 64 - rng.integers(0, 8, n), sb)
        vp = np.where(kind > 0.95, MASK32, vp)
        vn = np.where(kind > 0.95, 0, vn)
        sb = np.where(kind > 0.95, BIG + 32 * (kind > 0.975), sb)
        out.append((_t(vp), _t(vn), _t(sb)))
    return out


@pytest.mark.parametrize("n_words", [1, 2, 3, 5])
def test_lane_merge_matches_plain(n_words):
    """The carried kernel's column-0 merge (a lane a row, ballots) gives
    the plain version's 33-row merge, and one word back as it is."""
    rng = np.random.default_rng(500 + n_words)
    n = 3000
    words = _candidates(rng, n_words, n)
    got = merge_words_lanes(words)
    if n_words == 1:
        want = words[0]
    else:
        acc = _MergeAcc((1, n), "cpu")
        for vp, vn, sb in words:
            acc.add(vp[None], vn[None], sb[None])
        want = tuple(x[0] for x in acc.pack())
    for name, g, w in zip(("vp", "vn", "sb"), got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("s", [0, 1, 2])
def test_x_scan_lanes_matches_rows(s):
    """The X scan a lane a row (max, then the first row at it) against the
    row loop, over rows cut at the fragment's end (nr from below 0 to past
    32) and scores from small to near BIG, where X falls below -BIG."""
    rng = np.random.default_rng(600 + s)
    n = 4000
    vp, vn = _words(rng, n, density=rng.uniform(0.2, 1.0))
    esb = rng.integers(-10, 200, n)
    esb = np.where(rng.random(n) < 0.1, BIG - 1 - rng.integers(0, 40, n),
                   esb)
    nr = rng.integers(-3, 40, n)
    m, row = x_scan_lanes(_t(vp), _t(vn), _t(esb), s, _t(nr))
    sv, srow = x_scan_rows(_t(vp), _t(vn), _t(esb), s, _t(nr))
    counts = m > -BIG
    assert torch.equal(torch.where(counts, m, -BIG), sv)
    assert torch.equal(torch.where(counts, row, 0), srow)
    assert (~counts).any() and counts.any()


@pytest.mark.parametrize("carried", [False, True])
def test_split_columns_match_whole(carried):
    """Two slices of a slot's columns, split at its length as the carried
    kernel runs them (main bits below it, tail bits from it on, each slice
    entered by its own part of the bits before), give the bottom-row bits
    of all 31 columns run at once: the state out is main | tail."""
    rng = np.random.default_rng(700 + carried)
    lens = np.array([-1, 0, 1, 2, 5, 17, 31, 32, 33, 40])
    n = 100 * len(lens)
    slen = _t(np.repeat(lens, 100))
    if carried:
        bits, sign = (_t(rng.integers(0, 1 << 32, n)) for _ in range(2))
        hp, hn = bits & sign, bits & ~sign & MASK32
    else:
        hp, hn = torch.full((n,), ONES), torch.zeros(n, dtype=torch.int64)
    mp, mn, tp, tn = hp, hn, hp, hn
    for _ in range(2):
        vp, vn = (_t(x) for x in _words(rng, n))
        eq_cols = [_t(rng.integers(0, 1 << 32, n)) for _ in range(W)]
        hp, hn = whole_columns(vp, vn, eq_cols, hp, hn)
        mp, mn, tp, tn = split_columns(vp, vn, eq_cols, slen, mp, mn, tp,
                                       tn)
        assert not ((mp & tp) | (mn & tn)).any()
        assert torch.equal(mp | tp, hp) and torch.equal(mn | tn, hn)
