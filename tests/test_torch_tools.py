"""graphchainer_torch.tools against graphchainer_tpu.tools: every host
subcommand runs on the same input files through both packages' `main`,
and the output files are byte-equal (GAM decompressed: gzip stamps the
time).  The inputs are those of tests/test_cli_tools.py and
tests/test_aux_tools.py; the alignments the GAM-reading tools take come
from the port's CLI on the CPU (the toy read on the toy graph).
fusion-finder runs the port's GA model on the CPU and is held to a
recorded run of the JAX tool (tests/torch_fixtures/fusion_finder.json),
since its JAX side compiles new XLA shapes."""
import argparse
import gzip
import os
import subprocess
import sys

import pytest

from graphchainer_tpu import tools as JT
from graphchainer_torch import cli as TCLI
from graphchainer_torch import tools as TT
from graphchainer_torch.workload import fusion_workload

from conftest import TOY_READ
from test_aux_tools import write_gam, write_gfa
from test_cli_tools import make_vg_file
from test_torch_common import REPO, TOY_GFA_TEXT, load_fixture


def _write(path, text):
    path.write_text(text)
    return str(path)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """name -> path of every input file of the cases below."""
    d = tmp_path_factory.mktemp("tool_inputs")
    f = {"toy": _write(d / "toy.gfa", TOY_GFA_TEXT),
         "read": _write(d / "read.fa", f">read\n{TOY_READ}\n"),
         "truth": _write(d / "truth.nodes", "1 2 3 4\n")}
    # the toy read aligned by the port's CLI on the CPU (the flags of
    # test_cli_tools.cli_outputs)
    f["aln"] = str(d / "aln.gam")
    assert TCLI.main(["-g", f["toy"], "-f", f["read"], "-a", f["aln"],
                      "-b", "16", "--polish-band", "4",
                      "--seeds-minimizer-length", "11",
                      "--seeds-minimizer-windowsize", "5",
                      "--device", "cpu"]) == 0
    f["chain"] = str(d / "chain.gfa")
    write_gfa(f["chain"], [("1", "ACGTACGTAA"), ("2", "GGGGCCCCTT"),
                           ("3", "TTTTAAAACC"), ("4", "CCCCGGGGAA")],
              [("1", False, "2", False), ("2", False, "3", False),
               ("2", False, "4", False)])
    for name, alns in (
            ("path3", [("r1", [(1, False, 10), (2, False, 10),
                               (3, False, 10)])]),
            ("sup", [("r1", [(1, False, 10), (2, False, 10)]),
                     ("r2", [(1, False, 10), (2, False, 10)]),
                     ("r3", [(2, False, 10), (3, False, 10)])]),
            ("repeat", [("r1", [(2, False, 10)]), ("r2", [(2, False, 10)]),
                        ("r3", [(1, False, 10)]),
                        ("r4", [(3, False, 10), (3, False, 10)])])):
        f[name] = str(d / f"{name}.gam")
        write_gam(f[name], alns)
    f["unitig"] = str(d / "unitig.gfa")
    write_gfa(f["unitig"], [("1", "AAAA"), ("2", "CCCC"), ("3", "GGGG"),
                            ("4", "TTTT"), ("5", "ACAC")],
              [("1", False, "2", False), ("2", False, "3", False),
               ("3", False, "4", False), ("3", False, "5", False)])
    f["tippy"] = str(d / "tippy.gfa")
    write_gfa(f["tippy"], [("A", "A" * 50), ("B", "C" * 50), ("C", "G" * 50),
                           ("t1", "ACG"), ("t2", "TGA")],
              [("A", False, "B", False), ("B", False, "C", False),
               ("A", False, "t1", False), ("t1", False, "t2", False)])
    f["vg"] = str(d / "g.vg")
    make_vg_file(f["vg"], [(1, "ACGTACGT"), (2, "TTTT"), (3, "GGGG")],
                 [(1, 2, False, False, 0), (1, 3, False, True, 0)])
    f["mums"] = _write(d / "m.mums", "> readA\n  7    5   11   20\n"
                       "  7   40   61    9\n> readA Reverse\n"
                       "  9    2    3   15\n")
    f["junction"] = str(d / "junction.gfa")
    write_gfa(f["junction"], [("1", "ACGTAC"), ("2", "GTTTGG")],
              [("1", False, "2", False)])
    f["prefix"] = _write(d / "q.fa", ">q\nTACGTTTGGAAA\n")
    f["ref"] = _write(d / "ref.gfa", "S\t1\tACGTACGTAA\nS\t2\tGGGGCCCCTT\n"
                      "L\t1\t+\t2\t+\t0M\nP\tref\t1+,2+\t*\n")
    f["maf"] = _write(d / "r.maf", "a score=0\ns ref 8 6 + 20 GTAAGG\n"
                      "s read0 0 6 + 6 GTAAGG\n\n")
    return f


# subcommand argv with {input} names; the outputs are {out}, {out2}
HOST_CASES = {
    "gfa-path-sequence": "gfa-path-sequence --graph {ref} -o {out}",
    "gfa-path-sequence-vg": "gfa-path-sequence --graph {vg} -o {out}",
    "extract-path-sequence":
        "extract-path-sequence --gam {aln} --graph {toy} -o {out}",
    "select-longest": "select-longest --gam {aln} -o {out}.gam",
    "postprocess": "postprocess --gam {aln} -o {out}.gam",
    "postprocess-all": "postprocess --gam {aln} -o {out}.gam --method All",
    "extract-corrected":
        "extract-corrected --gam {aln} --graph {toy} -o {out}",
    "simulate-reads": "simulate-reads --graph {toy} --count 3 --length 60 "
                      "--seed 4 -o {out}",
    "simulate-reads-badread": "simulate-reads --graph {chain} --count 4 "
                              "--length 25 --profile badread -o {out}",
    "reverse-reads": "reverse-reads --reads {read} -o {out}",
    "node-pos-csv": "node-pos-csv --graph {toy} -o {out}",
    "subsequence-identity":
        "subsequence-identity --gam {aln} --truth {truth} -o {out}",
    "visualize": "visualize --gam {aln} --graph {toy} --width 30 -o {out}",
    "pick-adjacent-pairs": "pick-adjacent-pairs --gam {sup} -o {out}",
    "extract-exact-path-subgraph":
        "extract-exact-path-subgraph --graph {chain} --gam {path3} -o {out}",
    "extract-neighbourhood": "extract-neighbourhood --graph {chain} "
                             "--gam {path3} --length 12 -o {out}",
    "supported-subgraph": "supported-subgraph --graph {chain} --gam {sup} "
                          "--min-support 2 -o {out}",
    "unitigify": "unitigify --graph {unitig} -o {out}",
    "untip": "untip --graph {tippy} --max-len 10 --fraction 0.5 -o {out}",
    "untip-safe": "untip --graph {tippy} --max-len 10 --min-safe-len 200 "
                  "-o {out}",
    "estimate-repeat-count":
        "estimate-repeat-count --graph {chain} --gam {repeat} -o {out}",
    "pick-mummer-seeds":
        "pick-mummer-seeds --mums {mums} --max-seeds 2 -o {out}.gam",
    "brute-force-prefix-seeds": "brute-force-prefix-seeds --graph {junction}"
                                " --reads {prefix} --k 6 -o {out}.gam",
    "maf-to-alignment": "maf-to-alignment --graph {ref} --path-name ref "
                        "--maf {maf} -o {out}.gam --reads-out {out2}",
}


def _read(path):
    opener = gzip.open if path.endswith(".gam") else open
    with opener(path, "rb") as fh:
        return fh.read()


def _outputs(main, case, inputs, d):
    """Run one case through `main` with outputs under `d`; the bytes of
    each output file."""
    d.mkdir()
    argv = HOST_CASES[case].format(out=d / "out", out2=d / "out2",
                                   **inputs).split()
    assert main(argv) == 0
    return {p.name: _read(str(p)) for p in sorted(d.iterdir())}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_subcommand_matches_jax(case, inputs, tmp_path):
    want = _outputs(JT.main, case, inputs, tmp_path / "jax")
    got = _outputs(TT.main, case, inputs, tmp_path / "torch")
    assert want and got == want


def _subcommands(main, monkeypatch):
    """{subcommand: {option: default}} of a tools module's parser, read
    where its main parses the arguments."""
    seen = {}

    def grab(self, argv=None, namespace=None):
        sub = next(a for a in self._actions
                   if isinstance(a, argparse._SubParsersAction))
        seen.update({name: {o: a.default for a in p._actions
                            for o in a.option_strings}
                     for name, p in sub.choices.items()})
        raise SystemExit(0)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(SystemExit):
        main([])
    return seen


def test_every_subcommand_is_covered(monkeypatch):
    """The 21 subcommands of the JAX tool are the port's, with the same
    options and defaults (fusion-finder adds --device, default cuda), and
    each host subcommand has a case here."""
    want = _subcommands(JT.main, monkeypatch)
    got = _subcommands(TT.main, monkeypatch)
    assert len(want) == 21 and set(got) == set(want)
    for name in want:
        extra = {"--device"} if name == "fusion-finder" else set()
        assert set(got[name]) - set(want[name]) == extra, name
        assert {o: got[name][o] for o in want[name]} == want[name], name
    assert got["fusion-finder"]["--device"] == "cuda"
    covered = {HOST_CASES[c].split()[0] for c in HOST_CASES}
    assert covered == set(want) - {"fusion-finder"}


def fusion_case(tmp_path):
    """tests/test_cli_tools.py::test_fusion_finder's inputs
    (workload.fusion_workload), with every output: (argv, output
    paths)."""
    outs = {k: str(tmp_path / f"fusion.{k}")
            for k in ("tsv", "corr.fa", "gam")}
    argv = fusion_workload(str(tmp_path)) + [
        "--fusions-out", outs["tsv"], "--corrected-out", outs["corr.fa"],
        "-a", outs["gam"]]
    return argv, outs


def fusion_record(outs) -> dict:
    """The fusion finder's output files as JSON values (GAM as hex)."""
    return {k: (_read(p).hex() if k == "gam" else _read(p).decode())
            for k, p in outs.items()}


def test_fusion_finder_matches_jax(tmp_path):
    """fusion-finder on the card's path (the port's GraphAlignerModel, on
    the CPU here): the fused read is called with the JAX tool's bytes."""
    argv, outs = fusion_case(tmp_path)
    assert TT.main(argv + ["--device", "cpu"]) == 0
    want = load_fixture("fusion_finder")
    assert want["tsv"].startswith("fused\t") and want["tsv"].count("\n") == 1
    assert fusion_record(outs) == want


@pytest.mark.timeout(600)
def test_tools_module_runs_without_jax(tmp_path):
    """python -m graphchainer_torch.tools, with jax and the JAX package
    blocked, runs a subcommand end to end."""
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['graphchainer_tpu'] = None\n"
            "sys.argv = ['graphchainer_torch.tools'] + sys.argv[1:]\n"
            "runpy.run_module('graphchainer_torch.tools', "
            "run_name='__main__')\n")
    gfa = _write(tmp_path / "g.gfa", TOY_GFA_TEXT)
    out = tmp_path / "pos.csv"
    r = subprocess.run([sys.executable, "-c", code, "node-pos-csv",
                        "--graph", gfa, "-o", str(out)], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr
    assert out.read_text().startswith("node,approx_pos\n")
