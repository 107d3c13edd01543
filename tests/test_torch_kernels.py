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

from test_torch_common import (cuda_device, lane_major_inputs,  # noqa
                                     mixed_batch, t64)


def test_cpu_tensors_run_plain_versions():
    _cuda.reset_launches()
    args, kw = lane_major_inputs(16)
    res = frag_kernel.frag_core(*(t64(a) for a in args), **kw)
    ref = frag_align._frag_core_t(*(t64(a) for a in args), **kw)
    np.testing.assert_array_equal(res.best_in.numpy(),
                                  ref[3].permute(2, 1, 0).numpy())
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
        "frag_core", "polish_core", "polish_walk", "polish_core_serial",
        "polish_walk_serial"}


@pytest.mark.parametrize("bw", polish_kernel.BAND_WORDS)
def test_polish_entry_is_chosen_by_band_width(bw):
    """The warp-per-read entries take the band ramp's widths, the
    thread-per-read entries the rest; an entry can be forced only where
    it is built."""
    want = "warp" if bw in (8, 16, 32) else "serial"
    assert polish_kernel.entry_for(bw) == want
    assert polish_kernel._entry(bw, None) == want
    assert polish_kernel._entry(bw, "serial") == "serial"
    if want == "serial":
        with pytest.raises(ValueError, match="no 'warp' entry"):
            polish_kernel._entry(bw, "warp")
    with pytest.raises(ValueError, match="no 'fast' entry"):
        polish_kernel._entry(bw, "fast")


def test_polish_dump_layouts():
    """A dump reaches its entry in the memory order that entry reads: a
    (P, bw, R) view of read-major storage goes to the warp entry without
    a copy, and is copied column-major for the serial entry."""
    R, P, bw = 3, 5, 8
    store = torch.arange(R * P * bw, dtype=torch.int32).reshape(R, P, bw)
    view = store.permute(1, 2, 0)
    assert tuple(view.shape) == (P, bw, R)
    warp = polish_kernel._stored(view, True)
    assert warp.data_ptr() == store.data_ptr() and warp.is_contiguous()
    serial = polish_kernel._stored(view, False)
    assert serial.is_contiguous() and torch.equal(serial, view)
    assert serial.data_ptr() != store.data_ptr()
    back = polish_kernel._stored(serial, True)
    assert tuple(back.shape) == (R, P, bw) and torch.equal(back, store)
    base = torch.arange(R * P, dtype=torch.int32).reshape(R, P)
    assert polish_kernel._stored(base.permute(1, 0), True).data_ptr() \
        == base.data_ptr()


def test_kernel_calls_refuse_cpu_tensors():
    args, kw = lane_major_inputs(16)
    i32 = [to_i32_bits(t64(a)) for a in args]
    with pytest.raises(ValueError, match="CUDA tensor"):
        frag_kernel.frag_core_cuda(*i32[:5], i32[5][0], i32[6][0], **kw)
    planes_t, path_t, rl, pl = (to_i32_bits(t64(a)) for a in mixed_batch())
    with pytest.raises(ValueError, match="CUDA tensor"):
        polish_kernel.polish_core_cuda(planes_t, path_t, rl, pl, 4)
    with pytest.raises(ValueError, match="bw=3"):
        polish_kernel.polish_core_cuda(planes_t, path_t, rl, pl, 3)
    dump = [to_i32_bits(x) for x in linear_align._polish_core_t(
        *(t64(a) for a in mixed_batch()), 4)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        polish_kernel.polish_walk_cuda(*dump, planes_t, path_t, rl, pl, 4,
                                       1024, 512)
    with pytest.raises(ValueError, match="multiple of 16"):
        polish_kernel.polish_walk_cuda(*dump, planes_t, path_t, rl, pl, 4,
                                       1024, 500)


@pytest.mark.gpu
@pytest.mark.parametrize("B,max_in", [(16, 4), (32, 4), (96, 12)])
def test_frag_kernel_matches_plain(cuda_device, B, max_in):
    if max_in == 4:
        args, kw = lane_major_inputs(B)
    else:
        args, kw = lane_major_inputs(16)
        pad = B - args[0].shape[1]
        padw = lambda a, v: np.pad(  # noqa: E731
            a, [(0, 0)] * (a.ndim - 2) + [(0, pad), (0, 0)],
            constant_values=v)
        bi = np.concatenate([args[2], np.full((max_in - 4,) + args[2].shape[1:],
                                              -1, np.int32)])
        args = (padw(args[0], 0), padw(args[1], 0), padw(bi, -1),
                padw(args[3], -1)) + args[4:]
        kw = dict(kw, max_in=max_in)
    dev_args = [t64(a).to(cuda_device) for a in args]
    got = frag_kernel.frag_core(*dev_args, **kw)
    ref = frag_align._frag_core_t(*dev_args, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got[:3], ref[:3]):
        assert torch.equal(g.long().cpu(), r[0].cpu())
    assert torch.equal(got.best_in.long().cpu(),
                       ref[3].permute(2, 1, 0).cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("bw", [4, 8, 16, 32])
def test_polish_kernel_matches_plain(cuda_device, bw):
    planes_t, path_t, rl, pl = (t64(a).to(cuda_device)
                                for a in mixed_batch())
    ref = linear_align._polish_core_t(planes_t, path_t, rl, pl, bw)
    i32 = (to_i32_bits(planes_t), to_i32_bits(path_t), rl.int(), pl.int())
    for entry in ((None, "serial") if bw >= 8 else (None,)):
        got = polish_kernel.polish_core_cuda(*i32, bw, entry=entry)
        torch.cuda.synchronize()
        assert torch.equal(u32(got[0]).cpu(), ref[0].cpu()), entry
        assert torch.equal(u32(got[1]).cpu(), ref[1].cpu()), entry
        assert torch.equal(got[2].long().cpu(), ref[2].cpu()), entry
        assert torch.equal(got[3].long().cpu(), ref[3].cpu()), entry


@pytest.mark.gpu
@pytest.mark.parametrize("bw", [4, 8, 16, 32])
def test_polish_walk_matches_plain(cuda_device, bw):
    planes_t, path_t, rl, pl = (t64(a).to(cuda_device)
                                for a in mixed_batch())
    dump = linear_align._polish_core_t(planes_t, path_t, rl, pl, bw)
    i32 = (tuple(to_i32_bits(d) for d in dump)
           + (to_i32_bits(planes_t), to_i32_bits(path_t), rl.int(), pl.int()))
    for max_steps, cap in ((1024, 512), (1024, 256), (1024, 0)):
        ref = linear_align._polish_walk_t(*dump, planes_t, path_t, rl, pl,
                                          bw, max_steps, cap)
        got = polish_kernel.polish_walk(*dump, planes_t, path_t, rl, pl, bw,
                                        max_steps, cap)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), ref.cpu())
        got = polish_kernel.polish_walk_cuda(*i32, bw, max_steps, cap,
                                             entry="serial")
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), ref.cpu())


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
