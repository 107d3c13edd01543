"""Path generation and read simulation.

generate_path: random source-to-sink walk on the forward strand, for read
simulation ground truth (reference --generate-path,
src/AlignmentGraph.cpp:1498-1537).

simulate_reads: error-model read simulator (reference aux tool
src/SimulateReads.cpp): substitutions/insertions/deletions at given rates
from random positions of a path or the graph.

Copy of graphchainer_tpu/graph/simulate.py: the same numpy generators and
seeds, so a workload made here is the same reads.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from graphchainer_torch.graph.alignment_graph import AlignmentGraph


def generate_path(g: AlignmentGraph, seed: int = 0
                  ) -> Tuple[str, List[str]]:
    """Random forward-strand source-to-sink walk.  Returns (sequence,
    original node names along the walk)."""
    rng = np.random.default_rng(seed)
    sources = [v for v in range(g.n_nodes)
               if int(g.orig_node[v]) % 2 == 0
               and len(g.in_neighbors(v)) == 0]
    if not sources:
        raise ValueError("graph has no forward-strand source node")
    v = int(rng.choice(sources))
    seq_parts = [g.node_seq(v)]
    names = [g.gfa_name(v)]
    while True:
        outs = [int(w) for w in g.out_neighbors(v)
                if int(g.orig_node[w]) % 2 == 0]
        if not outs:
            break
        v = int(rng.choice(outs))
        seq_parts.append(g.node_seq(v))
        if g.gfa_name(v) != names[-1]:
            names.append(g.gfa_name(v))
    return "".join(seq_parts), names


def mutate_read(rng, seq: str, sub: float = 0.03, ins: float = 0.03,
                dele: float = 0.03) -> str:
    out = []
    for ch in seq:
        r = rng.random()
        if r < dele:
            continue
        if r < dele + sub:
            out.append(rng.choice(list("ACGT")))
        else:
            out.append(ch)
        if rng.random() < ins:
            out.append(rng.choice(list("ACGT")))
    return "".join(out)


def mutate_read_badread(rng, seq: str, mean_identity: float = 0.88,
                        identity_std: float = 0.03,
                        burst_enter: float = 0.003,
                        burst_exit: float = 0.25,
                        homopolymer_boost: float = 3.0) -> str:
    """Badread-style long-read error model (the reference's experiment
    protocol simulates with badread/pbsim, its
    scripts/10fold_test/gen_test.py:13-15, rather than
    the uniform iid model of its SimulateReads tool).  Three realistic
    departures from iid errors:

    * per-read identity drawn once (~N(mean, std), clipped) — some reads
      are much worse than others;
    * BURSTY errors: a 2-state Markov chain (background / burst) makes
      errors cluster in low-quality stretches instead of spreading
      uniformly (burst state multiplies the error rate ~8x);
    * HOMOPOLYMER indels: inside a homopolymer run of length >= 3 the
      indel probability is boosted and the inserted base duplicates the
      run (the dominant real ONT/PacBio error mode).
    """
    ident = float(np.clip(rng.normal(mean_identity, identity_std),
                          0.70, 0.99))
    base_err = 1.0 - ident
    out = []
    in_burst = False
    run_ch, run_len = "", 0
    for i, ch in enumerate(seq):
        if ch == run_ch:
            run_len += 1
        else:
            run_ch, run_len = ch, 1
        if in_burst:
            in_burst = rng.random() >= burst_exit
        else:
            in_burst = rng.random() < burst_enter
        err = base_err * (8.0 if in_burst else
                          1.0 / (1.0 + 8.0 * burst_enter / burst_exit))
        hp = run_len >= 3
        p_ind = err * (2 / 3) * (homopolymer_boost if hp else 1.0)
        p_sub = err / 3
        r = rng.random()
        if r < p_ind / 2:
            continue                       # deletion (hp: run shrinks)
        if r < p_ind:
            out.append(ch)                 # insertion: hp duplicates the
            out.append(ch if hp else str(rng.choice(list("ACGT"))))
            continue
        if r < p_ind + p_sub:
            out.append(str(rng.choice(list("ACGT"))))
        else:
            out.append(ch)
    return "".join(out)


def simulate_reads(path_seq: str, n: int, mean_len: int, seed: int = 0,
                   error_rate: float = 0.1,
                   len_std: Optional[int] = None,
                   profile: str = "uniform") -> List[Tuple[str, str]]:
    """Simulate n reads from a path sequence.

    profile="uniform": iid errors at `error_rate` split evenly between
    sub/ins/del (pbsim-like, the reference SimulateReads model).
    profile="badread": bursty + homopolymer-biased errors with per-read
    identity ~N(1 - error_rate, 0.03) (mutate_read_badread)."""
    rng = np.random.default_rng(seed)
    len_std = len_std or mean_len // 4
    reads = []
    per = error_rate / 3
    for i in range(n):
        L = max(50, int(rng.normal(mean_len, len_std)))
        L = min(L, len(path_seq))
        start = int(rng.integers(0, max(len(path_seq) - L, 1)))
        frag = path_seq[start:start + L]
        if profile == "badread":
            read = mutate_read_badread(rng, frag,
                                       mean_identity=1.0 - error_rate)
        else:
            read = mutate_read(rng, frag, sub=per, ins=per, dele=per)
        reads.append((f"sim_{i}_{start}_{L}", read))
    return reads


def tangle_bigraph(rng, n_knots: int = 10, arms: int = 8,
                   spacer: int = 40, arm_len: int = 8,
                   nested: bool = True, cycle_every: int = 0):
    """Adversarial dense variation graph: a backbone of `n_knots`
    superbubble KNOTS, each fanning into `arms` parallel variant arms
    that reconverge on one join node (join in-degree == arms, far above
    the default max_in=4 band cap).  With `nested`, one arm of every
    knot contains an inner bubble (nested superbubbles).  With
    `cycle_every` > 0, every k-th knot also gets a back edge from its
    join to its fork (short directed cycles — GA mode only; CLC refuses
    cyclic graphs like the reference).

    This is the stress shape VERDICT r2 weak #5 asks for: the benign
    bench graph never exercises the max_in truncation or fixed-band
    failure modes.
    """
    from graphchainer_torch.io.gfa import Bigraph
    bg = Bigraph()
    bases = list("ACGT")
    prev = bg.add_segment("start", "".join(rng.choice(bases, spacer)))
    for i in range(n_knots):
        fork = bg.add_segment(f"f{i}", "".join(rng.choice(bases, spacer)))
        bg.links.append((prev, False, fork, False, 0))
        join = bg.add_segment(f"j{i}", "".join(rng.choice(bases, spacer)))
        for a in range(arms):
            ln = max(1, arm_len + int(rng.integers(-arm_len // 2,
                                                   arm_len // 2 + 1)))
            if nested and a == 0:
                # nested bubble inside the first arm
                head = bg.add_segment(f"k{i}a{a}h",
                                      "".join(rng.choice(bases, ln)))
                x = bg.add_segment(f"k{i}a{a}x", str(rng.choice(bases)))
                y = bg.add_segment(f"k{i}a{a}y", str(rng.choice(bases)))
                tail = bg.add_segment(f"k{i}a{a}t",
                                      "".join(rng.choice(bases, ln)))
                bg.links.append((fork, False, head, False, 0))
                bg.links.append((head, False, x, False, 0))
                bg.links.append((head, False, y, False, 0))
                bg.links.append((x, False, tail, False, 0))
                bg.links.append((y, False, tail, False, 0))
                bg.links.append((tail, False, join, False, 0))
            else:
                arm = bg.add_segment(f"k{i}a{a}",
                                     "".join(rng.choice(bases, ln)))
                bg.links.append((fork, False, arm, False, 0))
                bg.links.append((arm, False, join, False, 0))
        if cycle_every and (i % cycle_every == cycle_every - 1):
            bg.links.append((join, False, fork, False, 0))
        prev = join
    end = bg.add_segment("end", "".join(rng.choice(bases, spacer)))
    bg.links.append((prev, False, end, False, 0))
    return bg
