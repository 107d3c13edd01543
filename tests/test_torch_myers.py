"""graphchainer_torch.ops.myers vs graphchainer_tpu.ops.myers: the 32-bit
Myers word primitives, carried in int64 on the torch side, equal the
uint32 JAX versions exactly."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphchainer_tpu.ops import myers as JM
from graphchainer_torch.ops import myers as TM

SPECIAL = np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0xAAAAAAAA,
                    0x55555555, 0xFFFF0000, 0x0000FFFF, 0x80000001],
                   dtype=np.uint32)


def words(rng, n):
    w = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([SPECIAL, w])


def as_t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("hin", [-1, 0, 1, "mixed"])
def test_advance_word_matches_jax(hin):
    rng = np.random.default_rng(7)
    n = 400
    # every special word paired with every other (carry-out cases of the
    # (eq & vp) + vp add included), then random words
    a = np.repeat(SPECIAL, len(SPECIAL))
    b = np.tile(SPECIAL, len(SPECIAL))
    vp = np.concatenate([a, words(rng, n)])
    eq = np.concatenate([b, words(rng, n)])
    vn = words(rng, len(vp) - len(SPECIAL)) & ~vp    # vp, vn disjoint
    sb = rng.integers(-1000, 1000, size=len(vp)).astype(np.int32)
    if hin == "mixed":
        h = rng.integers(-1, 2, size=len(vp)).astype(np.int32)
    else:
        h = np.full(len(vp), hin, np.int32)
    ref = JM.advance_word(jnp.asarray(vp), jnp.asarray(vn), jnp.asarray(sb),
                          jnp.asarray(eq), jnp.asarray(h))
    got = TM.advance_word(as_t(vp), as_t(vn), as_t(sb), as_t(eq), as_t(h))
    for name, r, g in zip(("vp", "vn", "sb", "hout"), ref, got):
        np.testing.assert_array_equal(np.asarray(r).astype(np.int64),
                                      g.numpy(), err_msg=name)


def test_advance_word_python_int_hin():
    rng = np.random.default_rng(8)
    vp, eq = words(rng, 64), words(rng, 64)
    vn = words(rng, 64) & ~vp
    sb = np.zeros(len(vp), np.int32)
    for h in (-1, 0, 1):
        ref = JM.advance_word(jnp.asarray(vp), jnp.asarray(vn),
                              jnp.asarray(sb), jnp.asarray(eq),
                              jnp.int32(h))
        got = TM.advance_word(as_t(vp), as_t(vn), as_t(sb), as_t(eq), h)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(np.asarray(r).astype(np.int64),
                                          g.numpy())


def test_popcount_and_score_before_start():
    rng = np.random.default_rng(9)
    vp, vn = words(rng, 500), words(rng, 500)
    sb = rng.integers(-5000, 5000, size=len(vp)).astype(np.int32)
    pc = jax.lax.population_count(jnp.asarray(vp))
    np.testing.assert_array_equal(np.asarray(pc).astype(np.int64),
                                  TM.popcount32(as_t(vp)).numpy())
    ref = JM.score_before_start(jnp.asarray(vp), jnp.asarray(vn),
                                jnp.asarray(sb))
    got = TM.score_before_start(as_t(vp), as_t(vn), as_t(sb))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_source_word():
    before = np.array([0, 5, -3, 1 << 20], np.int32)
    ref = JM.source_word(jnp.asarray(before))
    got = TM.source_word(as_t(before))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r).astype(np.int64),
                                      g.numpy())


def test_word_bits_roundtrip():
    """to_i32_bits / u32 keep the bit pattern of every 32-bit word."""
    rng = np.random.default_rng(10)
    w = words(rng, 300)
    x = as_t(w)
    i32 = TM.to_i32_bits(x)
    assert i32.dtype == torch.int32
    np.testing.assert_array_equal(i32.numpy().view(np.uint32), w)
    np.testing.assert_array_equal(TM.u32(i32).numpy(), w.astype(np.int64))
    r = torch.arange(32)
    np.testing.assert_array_equal(TM.above_mask(r).numpy(),
                                  np.asarray(JM._ABOVE).astype(np.int64))
