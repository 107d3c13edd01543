"""graphchainer_torch.align.repair (the port's copy of the polish-guided
bubble repair) against graphchainer_tpu.align.repair and the native
passes: the seven tests of tests/test_repair.py as cases of two tests.
Each case runs the port's repair_read (or rewrite_ops) and the JAX
module's on the same seeded graph, path and ops, and the port's
native.repair_batch (the same pass in C++); the hand-made bubbles are
also resolved alike by native.corridor_polish_batch, the exact corridor
re-polish that the pipeline runs.  The pipeline cases take their
positions and ops from the port's ChainerModel on the CPU."""
import functools

import numpy as np
import pytest

from graphchainer_tpu.align import repair as JR
from graphchainer_tpu.align.anchors import GraphTensors as JGraphTensors
from graphchainer_tpu.graph.alignment_graph import \
    build_alignment_graph as j_build
from graphchainer_tpu.io.gfa import Bigraph as JBigraph
from graphchainer_torch import native
from graphchainer_torch.align import polish
from graphchainer_torch.align import repair as TR
from graphchainer_torch.align.anchors import GraphTensors
from graphchainer_torch.graph.alignment_graph import build_alignment_graph
from graphchainer_torch.graph.mpc import build_mpc
from graphchainer_torch.graph.simulate import generate_path, simulate_reads
from graphchainer_torch.index.minimizer import build_index
from graphchainer_torch.io.gfa import Bigraph
from graphchainer_torch.models.chainer import ChainerConfig, ChainerModel
from graphchainer_torch.workload import build_bench_graph


def both_graphs(bg):
    """(port graph, JAX graph) of one port Bigraph."""
    jbg = JBigraph()
    for name, seq in zip(bg.names, bg.seqs):
        jbg.add_segment(name, seq)
    jbg.links += bg.links
    return build_alignment_graph(bg), j_build(jbg)


def path_positions(g, names_seq, bg):
    rows = []
    for nm in names_seq:
        d = bg.names.index(nm) * 2
        for off in range(len(bg.seqs[bg.names.index(nm)])):
            rows.append(g.find_split(d, off))
    return np.asarray(rows, dtype=np.int64)


def rand(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def hand_case(case):
    """tests/test_repair.py's hand-made inputs, from its rng fixture's
    seed: (Bigraph, read, path segment names, ops, whether a repair must
    fire)."""
    rng = np.random.default_rng(12345)
    bg = Bigraph()
    z = np.zeros
    if case in ("snp_arm_swap", "no_edit"):
        h = bg.add_segment("h", rand(rng, 20))
        a = bg.add_segment("a", "T")
        b = bg.add_segment("b", "G")
        t = bg.add_segment("t", rand(rng, 20))
        bg.links += [(h, False, a, False, 0), (h, False, b, False, 0),
                     (a, False, t, False, 0), (b, False, t, False, 0)]
        read = bg.seqs[0] + "G" + bg.seqs[3]       # the read takes arm b
        ops = z(len(read), np.uint8)
        if case == "snp_arm_swap":
            ops[20] = TR.OP_MISMATCH                # the path took arm a
        return bg, read, ["h", "a", "t"], ops, case == "snp_arm_swap"
    if case in ("deletion_arm", "missing_arm_insertion"):
        arm = "TTT" if case == "deletion_arm" else "CA"
        h = bg.add_segment("h", rand(rng, 20))
        a = bg.add_segment("a", arm)
        t = bg.add_segment("t", rand(rng, 20))
        bg.links += [(h, False, a, False, 0), (a, False, t, False, 0),
                     (h, False, t, False, 0)]
        if case == "deletion_arm":     # the path took the arm, the read not
            return (bg, bg.seqs[0] + bg.seqs[2], ["h", "a", "t"],
                    np.concatenate([z(20, np.uint8),
                                    np.full(3, TR.OP_DEL, np.uint8),
                                    z(20, np.uint8)]), True)
        return (bg, bg.seqs[0] + arm + bg.seqs[2], ["h", "t"],
                np.concatenate([z(20, np.uint8),
                                np.full(2, TR.OP_INS, np.uint8),
                                z(20, np.uint8)]), True)
    assert case == "real_error_not_repaired"
    h = bg.add_segment("h", rand(rng, 40))
    t = bg.add_segment("t", rand(rng, 40))
    bg.links += [(h, False, t, False, 0)]
    read = list(bg.seqs[0] + bg.seqs[1])
    read[40] = "A" if read[40] != "A" else "C"
    ops = z(len(read), np.uint8)
    ops[40] = TR.OP_MISMATCH
    return bg, "".join(read), ["h", "t"], ops, False


def same(a, b) -> bool:
    return (a is None and b is None) or (
        a is not None and b is not None and np.array_equal(a, b))


@functools.lru_cache(maxsize=None)
def pipeline_cases():
    """tests/test_repair.py's pipeline inputs: the bench graph at 4 kbp
    from its rng fixture's seed, 24 reads of ~600 bp at 12% error, and
    the port's alignments before the repair (bubble_repair off, no
    rescue): (port graph, JAX graph, port GraphTensors, [(read, positions,
    ops, score)])."""
    bg = build_bench_graph(np.random.default_rng(12345), 4000)
    tg, jg = both_graphs(bg)
    model = ChainerModel(tg, build_mpc(tg), build_index(tg, k=11, w=6),
                         ChainerConfig(bubble_repair=False,
                                       rescue_threshold=0), device="cpu")
    path_seq, _ = generate_path(tg, seed=5)
    reads = simulate_reads(path_seq, 24, min(len(path_seq), 600), seed=9,
                           error_rate=0.12)
    out = model.align_batch(reads)
    cases = [(reads[i][1], out[i].positions, out[i].ops, out[i].score)
             for i in range(len(reads))
             if out[i].ops is not None and len(out[i].positions)]
    return tg, jg, model.gx, cases


HAND = ("snp_arm_swap", "deletion_arm", "missing_arm_insertion",
        "real_error_not_repaired", "no_edit")


@pytest.mark.parametrize("case", HAND)
def test_hand_case_matches_jax_and_native(case):
    bg, read, names, ops, fires = hand_case(case)
    tg, jg = both_graphs(bg)
    positions = path_positions(tg, names, bg)
    np.testing.assert_array_equal(positions, path_positions(jg, names, bg))
    got = TR.repair_read(tg, None, read, positions, ops)
    assert same(got, JR.repair_read(jg, None, read, positions, ops))
    gx = GraphTensors.build(tg)
    [native_got] = native.repair_batch(gx, [positions], [ops], [read])
    assert same(got, native_got)
    assert (got is not None) == fires
    if fires:
        assert "".join(tg.node_seq(v)[o] for v, o in got) == read
        # the pipeline's exact corridor re-polish picks the same arm
        [corr] = native.corridor_polish_batch(
            gx, [positions], [ops], [read], [int((ops != TR.OP_MATCH).sum())])
        assert corr is not None and corr[0] == 0
        np.testing.assert_array_equal(corr[1], got)


@pytest.mark.parametrize("case", ("native_matches_python",
                                  "rewrite_ops_matches_repolish"))
def test_pipeline_case_matches_jax_and_native(case):
    tg, jg, gx, cases = pipeline_cases()
    assert len(cases) >= 8          # the workload exercises the repair
    fixed_n = native.repair_batch(gx, [p for _, p, _, _ in cases],
                                  [o for _, _, o, _ in cases],
                                  [r for r, _, _, _ in cases])
    if case == "native_matches_python":
        n_changed = 0
        for (read, positions, ops, _), fixed in zip(cases, fixed_n):
            got = TR.repair_read(tg, None, read, positions, ops)
            assert same(got, JR.repair_read(jg, None, read, positions, ops))
            assert same(got, fixed)
            n_changed += got is not None
        assert n_changed >= 1       # at least one repair fired
        return
    jgx = JGraphTensors.build(jg)
    rewritten = []
    for (read, positions, ops, score), fixed in zip(cases, fixed_n):
        if fixed is None:
            continue
        rw = TR.rewrite_ops(gx, read, score, ops, positions, fixed)
        jrw = JR.rewrite_ops(jgx, read, score, ops, positions, fixed)
        assert (rw is None) == (jrw is None)
        if rw is not None:
            assert rw[0] == jrw[0]
            np.testing.assert_array_equal(rw[1], jrw[1])
            rewritten.append((read, fixed, rw))
    assert rewritten
    # exactness: each rewrite's score equals a full re-polish's; validity:
    # the ops consume the read and the new path, and cost the score
    outs = polish.polish_batch([r for r, _, _ in rewritten],
                               [gx.positions_seq(f) for _, f, _ in rewritten],
                               bw=8, device="cpu")
    for (read, fixed, (new_score, new_ops)), oc in zip(rewritten, outs):
        assert new_score == oc.score
        assert (new_ops != TR.OP_INS).sum() == len(fixed)
        assert (new_ops != TR.OP_DEL).sum() == len(read)
        assert ((new_ops == TR.OP_MISMATCH).sum() + (new_ops == TR.OP_DEL)
                .sum() + (new_ops == TR.OP_INS).sum()) == new_score
