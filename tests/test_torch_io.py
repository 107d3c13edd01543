"""GAM / JSON / corrected-read outputs and .vg input of the port against
the JAX package, on the host only.

Both packages' pipeline.align_reads run on the same graph file (GFA or
.vg written with vg_wire) and reads, with the model replaced by one that
returns the same fixed alignments (the exact DAG oracle's, one with a
secondary, one read left unaligned): every writer then runs on the same
run, and no JAX function is compiled.  The GAF, the GAM (decompressed:
gzip stamps the time), the JSON and both corrected-read FASTAs must be
byte-equal."""
import gzip

import numpy as np
import pytest

from graphchainer_tpu import pipeline as JP
from graphchainer_tpu.align import anchors as JA
from graphchainer_tpu.align import oracle as JOR
from graphchainer_tpu.graph.alignment_graph import build_alignment_graph
from graphchainer_tpu.graph.simulate import generate_path, simulate_reads
from graphchainer_tpu.io.gfa import load_gfa, save_gfa
from graphchainer_tpu.models import chainer as JC
from graphchainer_tpu.models import optimal as JOPT
from graphchainer_torch import pipeline as TP
from graphchainer_torch.align import anchors as TA
from graphchainer_torch.models import chainer as TC
from graphchainer_torch.models import optimal as TOPT

from test_mpc import random_dag_bigraph
from test_torch_host import _vg_bytes


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """A random DAG as GFA and as .vg, 4 reads from its path, and fixed
    alignments as plain fields: read 0 with a secondary, read 3 none."""
    tmp = tmp_path_factory.mktemp("io")
    rng = np.random.default_rng(4)
    bg = random_dag_bigraph(rng, n_seg=16, p_edge=0.2, max_len=200)
    gfa = str(tmp / "g.gfa")
    save_gfa(bg, gfa)
    vg = str(tmp / "g.vg")
    with gzip.open(vg, "wb") as fh:
        fh.write(_vg_bytes(load_gfa(gfa), "ref"))
    g = build_alignment_graph(load_gfa(gfa))
    path_seq, _ = generate_path(g, seed=2)
    reads = simulate_reads(path_seq, 4, 300, seed=6, error_rate=0.1,
                           len_std=20)
    fa = str(tmp / "r.fa")
    with open(fa, "w") as fh:
        fh.write("".join(f">{n}\n{s}\n" for n, s in reads))
    nodes = np.nonzero(g.comp == 0)[0]
    cg = JOR.build_char_graph(g, nodes)
    inject = np.zeros(cg.n, dtype=np.int64)
    fields = {}
    for i, (name, seq) in enumerate(reads[:3]):
        lo, hi = 20, min(len(seq), 220)
        D = JOR.dag_dp(cg, seq[lo:hi], inject)
        end = int(np.argmin(D[:, hi - lo]))
        pos, ops = JOR.backtrace(cg, D, seq[lo:hi], inject, end)
        fields[name] = dict(name=name, seq=seq, positions=pos, ops=ops,
                            score=int(D[end, hi - lo]), seq_start=lo,
                            seq_end=hi, n_seeds=3)
    first = reads[0][0]
    sec = dict(fields[reads[1][0]], name=first, seq=reads[0][1],
               positions=fields[reads[1][0]]["positions"][:60],
               ops=fields[reads[1][0]]["ops"][:60], score=5, seq_start=0,
               seq_end=60, is_secondary=True)
    return dict(gfa=gfa, vg=vg, fa=fa, tmp=tmp, fields=fields,
                secondary={first: sec})


def fixed_model(case, RA, GT):
    """A model class whose align_batch returns the case's alignments as
    RA objects (unaligned where the case has none)."""
    class Fixed:
        def __init__(self, g, index, *args, **kw):
            self.g = g
            self.gx = GT.build(g)

        def align_batch(self, reads):
            out = []
            for name, seq in reads:
                f = case["fields"].get(name)
                if f is None:
                    out.append(RA(name=name, seq=seq,
                                  positions=np.zeros((0, 2), np.int64),
                                  ops=None, score=len(seq),
                                  seq_end=len(seq)))
                    continue
                a = RA(**f)
                if name in case["secondary"]:
                    a.secondary = [RA(**case["secondary"][name])]
                out.append(a)
            return out
    return Fixed


@pytest.mark.parametrize("graph", ["gfa", "vg"])
def test_outputs_match_jax(case, graph, monkeypatch):
    got = {}
    for key, pmod, omod, RA, GT in (
            ("jax", JP, JOPT, JC.ReadAlignment, JA.GraphTensors),
            ("torch", TP, TOPT, TC.ReadAlignment, TA.GraphTensors)):
        monkeypatch.setattr(omod, "OptimalAlignerModel",
                            fixed_model(case, RA, GT))
        if key == "torch":
            monkeypatch.setattr(pmod, "OptimalAlignerModel",
                                fixed_model(case, RA, GT))
        out = {k: str(case["tmp"] / f"{graph}.{key}.{k}")
               for k in ("gaf", "gam", "json", "corr", "clip")}
        params = pmod.PipelineParams(
            graph_file=case[graph], read_files=[case["fa"]],
            out_gaf=out["gaf"], out_gam=out["gam"], out_json=out["json"],
            out_corrected=out["corr"], out_corrected_clipped=out["clip"],
            mode="optimal", batch_size=2, seed_k=11, seed_w=6)
        if key == "torch":
            params.device = "cpu"
        stats = pmod.align_reads(params)
        data = {}
        for k, p in out.items():
            with (gzip.open if k == "gam" else open)(p, "rb") as fh:
                data[k] = fh.read()
        got[key] = (data, (stats.reads, stats.bp_in_reads,
                           stats.reads_with_an_alignment, stats.alignments,
                           stats.bp_in_alignments))
    assert got["torch"][1] == got["jax"][1] == (4, got["jax"][1][1], 3, 4,
                                                got["jax"][1][4])
    for k in got["jax"][0]:
        assert got["jax"][0][k] == got["torch"][0][k], k
    assert got["torch"][0]["gaf"].count(b"\n") == 3
    assert got["torch"][0]["corr"].count(b">") == 3


@pytest.mark.parametrize("graph", ["gfa", "vg"])
def test_cli_graph_statistics_matches_jax(case, graph, capsys):
    from graphchainer_tpu import cli as JCLI
    from graphchainer_torch import cli as TCLI
    outs = []
    for main in (JCLI.main, TCLI.main):
        assert main(["-g", case[graph], "--graph-statistics"]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "n_split_nodes" in outs[1]


@pytest.mark.parametrize("seed", [0, 7])
def test_cli_generate_path_matches_jax(case, seed):
    from graphchainer_tpu import cli as JCLI
    from graphchainer_torch import cli as TCLI
    files = []
    for key, main in (("jax", JCLI.main), ("torch", TCLI.main)):
        prefix = str(case["tmp"] / f"path{seed}.{key}")
        assert main(["-g", case["gfa"], "--generate-path", prefix,
                     "--generate-path-seed", str(seed)]) == 0
        files.append([open(prefix + ext).read()
                      for ext in (".fasta", ".nodes")])
    assert files[0] == files[1] and files[1][0].startswith(">generated_path")
