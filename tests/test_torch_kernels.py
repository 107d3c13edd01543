"""The CUDA kernels against their plain torch versions (exact equality),
and the wrappers' contract: a CPU tensor runs the plain version and
counts no launch; a CUDA kernel call with a tensor it does not take
raises.  Tests marked `gpu` need a card (the kernels have no CPU mode)
and skip without one.  The machine with the card has no jax, so run them
there without tests/conftest.py (which imports jax):
  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from graphchainer_torch.ops import _cuda, frag_align, frag_kernel
from graphchainer_torch.ops import linear_align, polish_kernel
from graphchainer_torch.ops.myers import to_i32_bits, u32

from test_torch_common import (cuda_device, host_args,  # noqa
                               lane_major_inputs, mixed_batch,
                               pack_polish_pairs, t64)


def test_cpu_tensors_run_plain_versions():
    _cuda.reset_launches()
    args, kw = host_args(32, padded=False)
    res = frag_kernel.frag_core(*args, **kw)
    ref = frag_align._frag_core_t(
        *(t64(a) for a in lane_major_inputs(32, padded=False)[0]), **kw)
    np.testing.assert_array_equal(res.best_in.numpy(),
                                  ref[3].permute(2, 1, 0).numpy())
    for got, want in zip(res[:3], ref[:3]):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want[0].numpy())
    planes_t, path_t, rl, pl = (t64(a) for a in mixed_batch())
    dump = polish_kernel.polish_core(planes_t, path_t, rl, pl, 4)
    ref = linear_align._polish_core_t(planes_t, path_t, rl, pl, 4)
    for a, b in zip(dump, ref):
        assert torch.equal(a, b)
    walk = polish_kernel.polish_walk(*dump, planes_t, path_t, rl, pl, 4,
                                     max_steps=1024, ops_cap=512)
    ref = linear_align._polish_walk_t(*ref, planes_t, path_t, rl, pl, 4,
                                      1024, 512)
    assert torch.equal(walk, ref)
    assert set(_cuda.launches().values()) == {0}
    assert set(_cuda.launches()) == {
        "frag_core", "frag_core_carried", "frag_wide", "polish_core",
        "polish_walk", "polish_core_any", "polish_walk_any"}


@pytest.mark.parametrize("bw", [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64,
                                100])
def test_polish_entry_is_chosen_by_band_width(bw):
    """The template warp-per-read fill takes the default band ramp's
    widths, the run-time-bw fill every other width, for any --polish-band
    start (a warp per read up to 64 words, a thread per read past them:
    test_polish_kernel_matches_plain at 100); the walk, one entry for
    every width, counts its launches by the same split."""
    want = "warp" if bw in (8, 16, 32) else "any"
    assert polish_kernel.entry_for(bw) == want


def test_polish_dump_layouts():
    """A dump reaches the walk in the memory order the walk reads at its
    width, which one rule (read_major, word_stride) decides: up to 64
    words read-major with the word stride bw rounded up to 4, past 64
    column-major.  A (P, bw, R) view of polish_core's read-major storage
    (padded or not) goes to the walk without a copy; a dump that lies the
    other way is copied, equal element for element."""
    assert [polish_kernel.word_stride(b) for b in (1, 3, 4, 5, 8, 33, 64)] \
        == [4, 4, 4, 8, 8, 36, 64]
    assert polish_kernel.read_major(64) and not polish_kernel.read_major(65)
    R, P = 3, 5
    for bw in (8, 3, 33):
        ws = polish_kernel.word_stride(bw)
        store = torch.arange(R * P * ws, dtype=torch.int32).reshape(R, P, ws)
        view = store[..., :bw].permute(1, 2, 0)
        assert tuple(view.shape) == (P, bw, R)
        got = polish_kernel._stored(view, bw)
        assert got.data_ptr() == store.data_ptr() and got.is_contiguous()
        assert tuple(got.shape) == (R, P, ws)
        cols = view.contiguous()
        back = polish_kernel._stored(cols, bw)
        assert tuple(back.shape) == (R, P, ws) and back.is_contiguous()
        assert torch.equal(back[..., :bw], store[..., :bw])
    store = torch.arange(R * P * 100, dtype=torch.int32).reshape(R, P, 100)
    view = store.permute(1, 2, 0)
    cols = polish_kernel._stored(view, 100)
    assert cols.is_contiguous() and torch.equal(cols, view)
    assert polish_kernel._stored(cols, 100).data_ptr() == cols.data_ptr()
    base = torch.arange(R * P, dtype=torch.int32).reshape(R, P)
    assert polish_kernel._stored(base.permute(1, 0), 12).data_ptr() \
        == base.data_ptr()
    assert torch.equal(polish_kernel._stored(base.permute(1, 0), 100),
                       base.t())


def test_kernel_calls_refuse_cpu_tensors():
    args, kw = host_args(16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        frag_kernel.frag_core_cuda(*args, **kw)
    # wrong dtypes (the int64 words and ids of the CPU route), shapes
    # and widths are refused before the device is looked at
    for i, bad, msg in ((0, args[0].long(), "node_eq: expected torch.int32"),
                        (3, args[3].int(), "band_in: expected torch.int8"),
                        (4, args[4].long(), "band_level: expected torch.int8"),
                        (6, args[6][:, :1], r"req: expected shape"),
                        (7, args[7][1:], r"rows: expected shape")):
        with pytest.raises(ValueError, match=msg):
            frag_kernel.frag_core_cuda(*args[:i], bad, *args[i + 1:], **kw)
    with pytest.raises(ValueError, match="band_in: expected shape"):
        frag_kernel.frag_core_cuda(*args, **dict(kw, max_in=12))
    wide = torch.full((args[2].shape[0], 129), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="B=129"):
        frag_kernel.frag_core_cuda(*args[:2], wide, *args[3:], **kw)
    planes_t, path_t, rl, pl = (to_i32_bits(t64(a)) for a in mixed_batch())
    with pytest.raises(ValueError, match="CUDA tensor"):
        polish_kernel.polish_core_cuda(planes_t, path_t, rl, pl, 4)
    # any band width gets past the wrapper to the device check
    with pytest.raises(ValueError, match="CUDA tensor"):
        polish_kernel.polish_core_cuda(planes_t, path_t, rl, pl, 3)
    dump = [to_i32_bits(x) for x in linear_align._polish_core_t(
        *(t64(a) for a in mixed_batch()), 4)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        polish_kernel.polish_walk_cuda(*dump, planes_t, path_t, rl, pl, 4,
                                       1024, 512)
    with pytest.raises(ValueError, match="multiple of 16"):
        polish_kernel.polish_walk_cuda(*dump, planes_t, path_t, rl, pl, 4,
                                       1024, 500)


def frag_case(case):
    """The kernel's CUDA-free arguments of one test case: the slice batch
    at B_eff (as run_fragments launches it), padded to B / max_in, or the
    hard batch."""
    if case == "hard":
        from graphchainer_torch.align.anchors import level_bucket
        from graphchainer_torch.workload import frag_hard_batch
        eq, ln, bn, bi, bl, ss, req, rows = frag_hard_batch(3, F=96)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa
        return ((t(eq.view(np.int32)), t(ln), t(bn), t(bi), t(bl), t(ss),
                 t(req.view(np.int32)), t(rows)),
                dict(S=req.shape[1], max_in=bi.shape[2],
                     n_levels=level_bucket(bl, bn.shape[1])))
    if case == "beff":
        return host_args(32, padded=False)
    B, max_in = case
    args, kw = host_args(min(B, 32))
    bn, bi, bl = args[2], args[3], args[4]
    F = bn.shape[0]
    pad = B - bn.shape[1]
    bn = torch.cat([bn, torch.full((F, pad), -1, dtype=bn.dtype)], 1)
    bl = torch.cat([bl, torch.full((F, pad), -1, dtype=bl.dtype)], 1)
    bi = torch.cat([bi, torch.full((F, pad, bi.shape[2]), -1,
                                   dtype=bi.dtype)], 1)
    bi = torch.cat([bi, torch.full((F, B, max_in - bi.shape[2]), -1,
                                   dtype=bi.dtype)], 2)
    return ((args[0], args[1], bn, bi, bl) + args[5:],
            dict(kw, max_in=max_in))


def test_frag_outputs_come_home_in_one_copy():
    """frag_kernel's outputs are views of one buffer, which to_numpy
    copies once (a result of separate tensors still converts), and
    anchors.upload packs arrays into one buffer at 16-byte offsets."""
    from graphchainer_torch.align.anchors import upload
    F, B, S = 5, 3, 2
    buf = torch.arange(3 * F + -(-F * B * S // 4), dtype=torch.int32)
    res = frag_kernel._result_views(buf, F, B, S)
    assert all(x.untyped_storage().data_ptr() == buf.data_ptr()
               for x in res[:4]) and set(res[4:]) == {None}
    assert res.best_in.shape == (F, B, S) and res.best_in.dtype == torch.int8
    host = frag_kernel.to_numpy(res)
    np.testing.assert_array_equal(host.best_slot, np.arange(F, 2 * F))
    np.testing.assert_array_equal(host.best_in.reshape(-1),
                                  buf[3 * F:].numpy().view(np.int8)[:F * B * S])
    sep = frag_kernel.to_numpy(frag_align.FragResult(
        *(x.clone() for x in res[:4])))
    for a, b in zip(sep, host):
        np.testing.assert_array_equal(a, b)
    # the carried entry's outputs share the buffer too; hp / hn come home
    # as uint32
    buf = torch.arange(6 * F + 3 * F * B + -(-F * B * S // 4),
                       dtype=torch.int32) - 7
    res = frag_kernel._result_views(buf, F, B, S, True, True)
    assert all(x.untyped_storage().data_ptr() == buf.data_ptr() for x in res)
    host = frag_kernel.to_numpy(res)
    assert host.out_hp.dtype == np.uint32 and host.out_hp.shape == (F, B)
    np.testing.assert_array_equal(host.out_hn.view(np.int32),
                                  buf[3 * F + 2 * F * B:3 * F + 3 * F * B]
                                  .numpy().reshape(F, B))
    np.testing.assert_array_equal(host.xrow, buf[5 * F + 3 * F * B:
                                                 6 * F + 3 * F * B].numpy())
    arrays = [np.arange(7, dtype=np.int32), np.arange(-3, 6, dtype=np.int8)
              .reshape(3, 3), np.arange(8, dtype=np.int32).reshape(2, 4)]
    views = upload(arrays, "cpu")
    assert len({v.untyped_storage().data_ptr() for v in views}) == 1
    for a, v in zip(arrays, views):
        assert v.data_ptr() % 16 == 0
        np.testing.assert_array_equal(a, v.numpy())


def carried_case(seed=3, F=96, **shape):
    """workload.frag_hard_batch with workload.frag_hard_carry's state and
    per-slot trims, as CPU tensors in the kernel's types, and the keyword
    arguments of frag_core with both extra outputs."""
    from graphchainer_torch.align.anchors import level_bucket
    from graphchainer_torch.workload import frag_hard_batch, frag_hard_carry
    eq, ln, bn, bi, bl, _, req, rows = frag_hard_batch(seed, F=F, **shape)
    carry, shifts = frag_hard_carry(seed, bn, ln)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa
    args = (t(eq.view(np.int32)), t(ln), t(bn), t(bi), t(bl), t(shifts),
            t(req.view(np.int32)), t(rows))
    return args, dict(S=req.shape[1], max_in=bi.shape[2],
                      n_levels=level_bucket(bl, bn.shape[1]),
                      carry=tuple(t(c.view(np.int32)) for c in carry),
                      want_state=True, want_xcells=True)


def test_carried_plain_version():
    """On CPU tensors the carried windows run the plain version: every
    field is there, in the kernel's types, and a carried state changes
    the result of the same batch."""
    args, kw = carried_case()
    res = frag_kernel.frag_core(*args, **kw)
    F, B = args[2].shape
    for name in ("out_ssb", "out_hp", "out_hn"):
        x = getattr(res, name)
        assert x.dtype == torch.int32 and x.shape == (F, B), name
    for name in ("xbest", "xslot", "xrow"):
        assert getattr(res, name).shape == (F,), name
    fresh = frag_kernel.frag_core(*args, **dict(kw, carry=None))
    assert not torch.equal(res.best_score, fresh.best_score)
    pad = args[4] < 0
    assert (res.out_ssb[pad] == 1 << 28).all()
    assert (res.out_hp[pad] == 0).all() and (res.out_hn[pad] == 0).all()
    with pytest.raises(ValueError, match="CUDA tensor"):
        frag_kernel.frag_core_carried_cuda(*args, **kw)
    with pytest.raises(ValueError, match="seed_shift: expected shape"):
        frag_kernel.frag_core_carried_cuda(*args[:5], args[5][:, :1],
                                           *args[6:], **kw)


def test_frag_hard_batch_has_its_cases():
    """workload.frag_hard_batch holds every case it names."""
    from graphchainer_torch.workload import frag_hard_batch
    eq, ln, bn, bi, bl, ss, req, rows = frag_hard_batch(3, F=96)
    F, B = bn.shape
    max_in = bi.shape[2]
    assert (ln[bn[:, 0]] == ss).any() and (ss == 32).any()
    assert {1, 31, 32, 33, 63, 64, 65, 96} <= set(rows.tolist())
    assert (ln[bn[bn >= 0]] >= 32).any() and (ln[bn[bn >= 0]] == 1).any()
    assert ((bi >= 0).sum(2) == max_in).any() and (bi >= B).any()
    assert ((bn[:, :-1] < 0) & (bn[:, 1:] >= 0)).any()
    f, b, e = np.nonzero((bi >= 0) & (bi < B))
    u = bi[f, b, e].astype(np.int64)
    assert (bn[f, u] < 0).any()                       # from a pad slot
    assert (bl[f, u] >= bl[f, b]).any()               # not from below
    # words: row bits only below the fragment's end, Eq bits only below
    # the node's length
    rr = np.arange(32 * req.shape[1]).reshape(req.shape[1], 32)
    assert not (((req[..., None] >> (rr % 32)[:, None, :].astype(np.uint32))
                 & 1).astype(bool)
                & (rr[None, :, None, :] >= rows[:, None, None, None])).any()
    assert ((eq >> np.minimum(ln, 31)[:, None].astype(np.uint32))
            [ln < 32] == 0).all()


def test_ptxas_report_reads_nvcc_output():
    """chip_smoke's reading of nvcc -Xptxas -v: registers, stack frame and
    spills per instantiation of the kernel asked for, and no other."""
    import chip_smoke
    log = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116frag_core_kernelILi16EEEvPK4int4' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116frag_core_kernelILi16EEEvPK4int4
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 115 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123polish_core_warp_kernelILi8EEEvPKj' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_123polish_core_warp_kernelILi8EEEvPKj
    2048 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 77 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116frag_core_kernelILi8EEEvPK4int4' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116frag_core_kernelILi8EEEvPK4int4
    16 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
"""
    assert chip_smoke.ptxas_report(log, "frag_core_kernel") == {
        "frag_core_kernel<16>": (115, 0, 0, 0),
        "frag_core_kernel<8>": (255, 16, 8, 4)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["beff", (16, 4), (32, 4), (96, 12),
                                  "hard"], ids=str)
def test_frag_kernel_matches_plain(cuda_device, case):
    """The kernel against its plain version (lane_major + _frag_core_t) on
    the same host-typed tensors on the card."""
    args, kw = frag_case(case)
    dev_args = [a.contiguous().to(cuda_device) for a in args]
    got = frag_kernel.frag_core(*dev_args, **kw)
    ref = frag_align._frag_core_t(*frag_align.lane_major(
        *dev_args[:4], dev_args[5], dev_args[6], dev_args[7], dev_args[4]),
        **kw)
    torch.cuda.synchronize()
    for g, r in zip(got[:3], ref[:3]):
        assert torch.equal(g.long().cpu(), r[0].cpu())
    assert torch.equal(got.best_in.long().cpu(),
                       ref[3].permute(2, 1, 0).cpu())


_GPU_BANDS = [1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32, 33, 48, 64, 100]
# both entries; 3, 6, 12, 24, 48 ramp from a start of 3 or 12; 33 and 64
# take two words a lane, 100 the run-time entries' thread per read


@pytest.mark.gpu
@pytest.mark.parametrize("bw", _GPU_BANDS)
def test_polish_kernel_matches_plain(cuda_device, bw):
    planes_t, path_t, rl, pl = (t64(a).to(cuda_device)
                                for a in mixed_batch())
    ref = linear_align._polish_core_t(planes_t, path_t, rl, pl, bw)
    i32 = (to_i32_bits(planes_t), to_i32_bits(path_t), rl.int(), pl.int())
    _cuda.reset_launches()
    got = polish_kernel.polish_core_cuda(*i32, bw)
    torch.cuda.synchronize()
    assert torch.equal(u32(got[0]).cpu(), ref[0].cpu())
    assert torch.equal(u32(got[1]).cpu(), ref[1].cpu())
    assert torch.equal(got[2].long().cpu(), ref[2].cpu())
    assert torch.equal(got[3].long().cpu(), ref[3].cpu())
    name = "polish_core" if bw in (8, 16, 32) else "polish_core_any"
    assert _cuda.launches()[name] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("bw", [1, 2, 12, 33, 64])
def test_polish_kernel_steep_bands_match_plain(cuda_device, bw):
    """workload.polish_hard_pairs: reads 20 and 40 times their paths'
    length, whose bands jump several words a column and take the serial
    fill inside the warp kernels, where at bw = 1 the reference's plane
    window lags the band (the shift is clamped to one word before its
    refill test), mixed with ordinary reads, empty reads and paths."""
    from graphchainer_torch.workload import polish_hard_pairs
    pairs = [(r, p) for _, r, p in polish_hard_pairs(5, 4, 1500)]
    planes_t, path_t, rl, pl = (t64(a).to(cuda_device) for a in
                                pack_polish_pairs(pairs, 2048, 2048))
    ref = linear_align._polish_core_t(planes_t, path_t, rl, pl, bw)
    got = polish_kernel.polish_core_cuda(
        to_i32_bits(planes_t), to_i32_bits(path_t), rl.int(), pl.int(), bw)
    torch.cuda.synchronize()
    for i, (g, r) in enumerate(zip(got, ref)):
        g = u32(g) if i < 2 else g.long()
        assert torch.equal(g.cpu(), r.cpu()), i


def _read_major(dump, bw):
    """A (P, bw, R) / (P, R) dump's values as views of read-major storage
    with the word stride word_stride(bw), as polish_core returns them."""
    ws = polish_kernel.word_stride(bw)
    out = []
    for t in dump[:3]:
        P, _, R = t.shape
        store = torch.zeros((R, P, ws), dtype=t.dtype, device=t.device)
        store[..., :bw] = t.permute(2, 0, 1)
        out.append(store[..., :bw].permute(1, 2, 0))
    return out + [dump[3].t().contiguous().t()]


def _check_walk(dump, planes_t, path_t, rl, pl, bw, caps):
    """The walk against _polish_walk_t on one dump, handed to the kernel
    column-major and read-major (the wrapper copies the one that does not
    lie the way the walk reads it at this width)."""
    i32 = (to_i32_bits(planes_t), to_i32_bits(path_t), rl.int(), pl.int())
    words = [to_i32_bits(d) for d in dump]
    for max_steps, cap in caps:
        ref = linear_align._polish_walk_t(*dump, planes_t, path_t, rl, pl,
                                          bw, max_steps, cap)
        got = polish_kernel.polish_walk(*dump, planes_t, path_t, rl, pl, bw,
                                        max_steps, cap)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), ref.cpu())
        for handed in (words, _read_major(words, bw)):
            got = polish_kernel.polish_walk_cuda(*handed, *i32, bw,
                                                 max_steps, cap)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), ref.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("bw", _GPU_BANDS)
def test_polish_walk_matches_plain(cuda_device, bw):
    planes_t, path_t, rl, pl = (t64(a).to(cuda_device)
                                for a in mixed_batch())
    dump = linear_align._polish_core_t(planes_t, path_t, rl, pl, bw)
    _check_walk(dump, planes_t, path_t, rl, pl, bw,
                ((1024, 512), (1024, 256), (1024, 0)))


@pytest.mark.gpu
@pytest.mark.parametrize("bw", _GPU_BANDS)
def test_polish_walk_steep_bands_match_plain(cuda_device, bw):
    """The walk on workload.polish_hard_pairs (reads 20 and 40 times their
    paths' length, long indels along the band's edges, empty reads and
    paths, ordinary reads), over the plain fill's dump, under the
    polish's ops_cap and one that long walks overflow."""
    from graphchainer_torch.align.polish import _ops_cap
    from graphchainer_torch.workload import polish_hard_pairs
    pairs = [(r, p) for _, r, p in polish_hard_pairs(5, 4, 1500)]
    planes_t, path_t, rl, pl = (t64(a).to(cuda_device) for a in
                                pack_polish_pairs(pairs, 2048, 2048))
    dump = linear_align._polish_core_t(planes_t, path_t, rl, pl, bw)
    _check_walk(dump, planes_t, path_t, rl, pl, bw,
                ((4096, _ops_cap(2048, 2048, bw)), (4096, 1600)))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["carried", "carried-wide", "fresh-state",
                                  "carried-B96", "xcells-only",
                                  "state-only"])
def test_frag_kernel_carried_entry_matches_plain(cuda_device, case):
    """The carried entry against its plain version on the card: a random
    carried state and per-slot trims on the hard batch (B=8 / S=3, B=48 /
    S=2 at GA mode's width, and B=96 / max_in=12 on 45 fragments), with
    slots of length 0 (a whole trim), 1, 32 and longer; a fresh window
    with the state and X-cell outputs; and each extra output alone (no
    tail columns, or no X scan); every output exact."""
    if case == "carried-wide":
        args, kw = carried_case(4, F=48, B=48, max_in=4, S=2)
    elif case == "carried-B96":
        args, kw = carried_case(5, F=45, B=96, max_in=12, S=2)
    else:
        args, kw = carried_case()
    if case == "xcells-only":
        kw = dict(kw, want_state=False)
    if case == "state-only":
        kw = dict(kw, want_xcells=False)
    if case == "fresh-state":
        args = args[:5] + (torch.zeros(args[2].shape[0],
                                       dtype=torch.int32),) + args[6:]
        kw = dict(kw, carry=None)
    dev = lambda t: t.contiguous().to(cuda_device)  # noqa: E731
    carry = None if kw["carry"] is None else tuple(map(dev, kw["carry"]))
    got = frag_kernel.frag_core(*map(dev, args), **dict(kw, carry=carry))
    ref = frag_kernel.frag_core(*args, **kw)
    torch.cuda.synchronize()
    for name in frag_align.FragResult._fields:
        want = getattr(ref, name)
        if want is None:
            assert getattr(got, name) is None, name
            continue
        assert torch.equal(getattr(got, name).cpu(), want), name


@pytest.mark.gpu
def test_align_batch_cuda_matches_cpu(cuda_device):
    from graphchainer_torch.models.chainer import ChainerModel
    from test_torch_common import slice_case_port
    g, mpc, index, _, reads = slice_case_port()
    _cuda.reset_launches()
    a = ChainerModel(g, mpc, index, device=cuda_device).align_batch(reads)
    n = _cuda.launches()
    assert min(n[k] for k in ("frag_core", "polish_core",
                              "polish_walk")) > 0, n
    b = ChainerModel(g, mpc, index, device="cpu").align_batch(reads)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x.positions),
                                      np.asarray(y.positions))
        assert x.score == y.score
        assert (x.ops is None) == (y.ops is None)
        if x.ops is not None:
            np.testing.assert_array_equal(x.ops, y.ops)


@pytest.mark.gpu
def test_align_batch_two_shards_of_one_card(cuda_device):
    """The model on two shards of one card (a device list may repeat a
    device): one shard's alignments, each shard launching every kernel
    of the main path."""
    from graphchainer_torch.models.chainer import ChainerModel
    from test_torch_common import slice_case_port
    g, mpc, index, _, reads = slice_case_port()
    card = torch.device("cuda", torch.cuda.current_device())
    one = ChainerModel(g, mpc, index, device=card).align_batch(reads[1:])
    _cuda.reset_launches()
    two = ChainerModel(g, mpc, index, device=(card, card)).align_batch(
        reads[1:])
    per = _cuda.launches_by_shard()
    for shard in (0, 1):
        assert min(per[shard][k] for k in ("frag_core", "polish_core",
                                           "polish_walk")) > 0, per
    for x, y in zip(one, two):
        np.testing.assert_array_equal(np.asarray(x.positions),
                                      np.asarray(y.positions))
        assert x.score == y.score
        np.testing.assert_array_equal(x.ops, y.ops)


@pytest.mark.gpu
def test_kernels_launch_on_their_tensors_device(cuda_device):
    """A kernel runs on the card its tensors are on, whatever the current
    device: frag_core and both polish kernels on the second card, called
    with the first card current, equal their plain versions."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    other = torch.device("cuda", 1)
    args, kw = frag_case("beff")
    dev_args = [a.contiguous().to(other) for a in args]
    ref = frag_align._frag_core_t(*frag_align.lane_major(
        *dev_args[:4], dev_args[5], dev_args[6], dev_args[7], dev_args[4]),
        **kw)
    planes_t, path_t, rl, pl = (t64(a).to(other) for a in mixed_batch())
    dump_ref = linear_align._polish_core_t(planes_t, path_t, rl, pl, 8)
    walk_ref = linear_align._polish_walk_t(*dump_ref, planes_t, path_t, rl,
                                           pl, 8, 1024, 512)
    with torch.cuda.device(0):
        got = frag_kernel.frag_core(*dev_args, **kw)
        dump = polish_kernel.polish_core(planes_t, path_t, rl, pl, 8)
        walk = polish_kernel.polish_walk(*dump, planes_t, path_t, rl, pl, 8,
                                         max_steps=1024, ops_cap=512)
    torch.cuda.synchronize(other)
    assert got.best_score.device == other and walk.device == other
    for g, r in zip(got[:3], ref[:3]):
        assert torch.equal(g.long().cpu(), r[0].cpu())
    assert torch.equal(u32(dump[0]).cpu(), dump_ref[0].cpu())
    assert torch.equal(walk.cpu(), walk_ref.cpu())


def test_launch_counts_survive_thread_contention():
    """The pipeline counts launches from a thread pool: no update is lost
    with more threads than cores and a short switch interval."""
    import sys
    import threading
    _cuda.reset_launches()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [_cuda.count_launch("polish_walk")
                            for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert _cuda.launches()["polish_walk"] == 16 * 2000
    _cuda.reset_launches()
    assert set(_cuda.launches().values()) == {0}


def test_split_lookup_is_published_whole():
    """Concurrent first calls of GraphTensors.split_lookup all see the
    complete (keys, values) pair."""
    import sys
    import threading
    from graphchainer_torch.align.anchors import GraphTensors
    from test_torch_common import slice_case_port
    g = slice_case_port()[0]
    want = GraphTensors.build(g).split_lookup()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(5):
            gx = GraphTensors.build(g)
            got = []
            threads = [threading.Thread(
                target=lambda: got.append(gx.split_lookup()))
                for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            assert len(got) == 16
            for keys, vals in got:
                np.testing.assert_array_equal(keys, want[0])
                np.testing.assert_array_equal(vals, want[1])
    finally:
        sys.setswitchinterval(old)


# ---- frag_wide: the F-major DP of optimal mode and seedless DP ----------

def wide_hard_case(seed=3, full_start=True, S=3):
    """workload.frag_wide_hard_batch (S slices) as align_fragments' CPU
    arguments in the kernel's types (args, keyword args)."""
    from graphchainer_torch.workload import frag_wide_hard_batch
    eq, ln, bn, bi, bl, ss, req, rows, base, nl = frag_wide_hard_batch(
        seed, S=S)
    t = torch.from_numpy
    return ((t(eq.view(np.int32)), t(ln), t(bn), t(bi), t(ss),
             t(req.view(np.int32)), t(rows)),
            dict(n_slices=req.shape[1], max_in=bi.shape[2],
                 full_start=full_start, band_level=t(bl), n_levels=nl,
                 seed_base=t(base)))


def test_align_fragments_cpu_runs_plain_version():
    """On CPU tensors align_fragments is its plain version and launches
    nothing; without want_state the plain version skips the columns past
    each slot's length and gives the same outputs."""
    _cuda.reset_launches()
    args, kw = wide_hard_case()
    got = frag_align.align_fragments(*args, **kw)
    lean = frag_align.align_fragments_plain(*args, **kw, want_state=False)
    assert _cuda.launches()["frag_wide"] == 0
    assert got.best_in.dtype == torch.int8 and got.out_ssb is not None
    assert lean.out_ssb is None
    for name in ("best_score", "best_slot", "best_col", "best_in",
                 "end_score", "end_col"):
        assert torch.equal(getattr(got, name), getattr(lean, name)), name


def test_wide_kernel_call_refuses_what_it_does_not_take():
    args, kw = wide_hard_case()
    kw = dict(kw, S=kw.pop("n_slices"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        frag_kernel.frag_wide_cuda(*args[:4], kw.pop("band_level"),
                                   *args[4:], **kw)
    args, kw = wide_hard_case()
    bl = kw.pop("band_level")
    kw = dict(kw, S=kw.pop("n_slices"))
    base = (args[0], args[1], args[2], args[3], bl) + args[4:]
    for i, bad, msg in ((3, args[3].to(torch.int8),
                         "band_in: expected torch.int16"),
                        (4, bl.long(), "band_level: expected torch.int32"),
                        (5, args[4][:, None].expand(-1, 64).contiguous(),
                         "seed_shift: expected shape"),
                        (6, args[5][:, :1], "req: expected shape")):
        with pytest.raises(ValueError, match=msg):
            frag_kernel.frag_wide_cuda(*base[:i], bad, *base[i + 1:], **kw)
    with pytest.raises(ValueError, match="n_levels=5000"):
        frag_kernel.frag_wide_cuda(*base, **dict(kw, n_levels=5000))
    wide = torch.full((args[2].shape[0], 4097), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="B=4097"):
        frag_kernel.frag_wide_cuda(*base[:2], wide, *base[3:], **kw)


def test_ptxas_report_reads_type_arguments():
    """The same reading for frag_wide_kernel, whose template argument is
    the pointer type."""
    import chip_smoke
    log = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116frag_wide_kernelIaEEvPK5uint4PKiS5_PKs' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116frag_wide_kernelIaEEvPK5uint4PKiS5_PKs
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116frag_core_kernelILi8EEEvPK4int4' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116frag_core_kernelILi8EEEvPK4int4
    16 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116frag_wide_kernelIsEEvPK5uint4PKiS5_PKs' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116frag_wide_kernelIsEEvPK5uint4PKiS5_PKs
    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers
"""
    assert chip_smoke.ptxas_report(log, "frag_wide_kernel") == {
        "frag_wide_kernel<int8_t>": (90, 0, 0, 0),
        "frag_wide_kernel<int16_t>": (96, 8, 0, 0)}


def test_ptxas_report_reads_plain_kernels():
    """The same reading for a kernel that is no template (frag_carried_
    kernel), keyed by its name, beside a template kernel at argument 0
    (polish_walk_tile_kernel<0>, the run-time band width)."""
    import chip_smoke
    log = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119frag_carried_kernelEPK4int4PKiS4_PKaS6_S4_S2_S4_iiiiiPiS7_S7_PaNS_3ExtE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119frag_carried_kernelEPK4int4PKiS4_PKaS6_S4_S2_S4_iiiiiPiS7_S7_PaNS_3ExtE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123polish_walk_tile_kernelILi0EEEvPKjS2_PKiS4_S2_S2_S4_S4_iiiiiiPx' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_123polish_walk_tile_kernelILi0EEEvPKjS2_PKiS4_S2_S2_S4_S4_iiiiiiPx
    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers
"""
    assert chip_smoke.ptxas_report(log, "frag_carried_kernel") == {
        "frag_carried_kernel": (72, 0, 0, 0)}
    assert chip_smoke.ptxas_report(log, "polish_walk_tile_kernel") == {
        "polish_walk_tile_kernel<0>": (40, 0, 4, 4)}
    assert chip_smoke.ptxas_report(log, "frag_core_kernel") == {}


def wide_bench_case(case):
    """align_fragments' arguments of the bench graph (bench.py's 60 kbp
    graph) on the CPU: a whole-component band (B = 4096) or the seedless
    tiles (B = 1024) against a 64-row prefix of a bench read; the tiles
    against a 512-row prefix (S = 16, more slices than a block's first
    warp); and the tiles with one in-edge turned to come from a higher
    level, which sends every tile of that band off the wavefront."""
    from graphchainer_torch.align.seedless import FullstartScanner
    from graphchainer_torch.models.optimal import OptimalAlignerModel
    from graphchainer_torch.workload import bench_workload
    g, _, index, _, reads, _ = bench_workload(60_000, 1, 3000)
    read = reads[0][1]
    if case == "B4096":
        args, kw = OptimalAlignerModel(g, index, device="cpu"
                                       ).component_inputs(read[:64], 0)
    else:
        scan = FullstartScanner(g, OptimalAlignerModel(
            g, index, device="cpu").gx, device="cpu")
        args, kw = scan.scan_inputs(read, offsets=(0,), prefix_rows=64)[:2]
        if case == "B1024-irregular":
            bi, bl = args[3].clone(), kw["band_level"]
            f, b = 0, int(torch.nonzero(bl[0] == 5)[0])
            bi[:, b, 0] = int(torch.nonzero(bl[0] == 9)[0])
            args = args[:3] + (bi,) + args[4:]
    # the CPU route keeps node words as int64, the kernel takes their bits
    return (to_i32_bits(args[0]),) + args[1:], kw


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["B64", "B64-no-full-start", "B64-S40",
                                  "B64-S150", "B1024", "B1024-irregular",
                                  "B4096"])
def test_frag_wide_matches_plain(cuda_device, case):
    """The kernel against its plain version (align_fragments_plain on
    the CPU, on the same inputs), every output exact: the hard batch
    (int8 pointers, int16 in-edges, pad and length-0 slots, fragments on
    the level-by-level path) at 3 slices, at 40 (a block of two warps)
    and at 150 (two rounds of 128 slices), and the bench graph's bands."""
    if case.startswith("B64"):
        S = int(case[5:]) if case.startswith("B64-S") else 3
        args, kw = wide_hard_case(full_start=case != "B64-no-full-start",
                                  S=S)
    else:
        args, kw = wide_bench_case(case)
    ref = frag_align.align_fragments_plain(*args, **kw, want_state=False)
    _cuda.reset_launches()
    got = frag_align.align_fragments(
        *(a.to(cuda_device) for a in args),
        **{k: (v.to(cuda_device) if torch.is_tensor(v) else v)
           for k, v in kw.items()})
    torch.cuda.synchronize()
    assert _cuda.launches()["frag_wide"] == 1
    for name in ("best_score", "best_slot", "best_col", "best_in",
                 "end_score", "end_col"):
        a, b = getattr(got, name).cpu(), getattr(ref, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
