"""The harness end to end at a tiny size on the CPU (the program's plain
torch versions in place of its kernels), on test-only cells kept in
gcbench/tests/data: a sound run is correct; a run with the program broken
underneath, or with the configuration's control switch on, is not.  The
`gpu` test runs a tiny cell through the card's kernels."""
from __future__ import annotations

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from gcbench import run

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def tiny(cell="tiny.clr", seed=11, seconds=3, trace=0, device="cpu",
         control=False):
    out = io.StringIO()
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)],
                  dirs=[DATA, run.GCBENCH], device=device,
                  require_card=device != "cpu", control=control, out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_sound_run_is_correct():
    r = tiny()
    assert r["correct"] is True
    assert r["attempted"] > 0 and r["failed"] <= r["attempted"]
    assert set(r["metrics"]) == {"read_kbp_per_s", "mean_norm_ed",
                                 "peak_rss_gb", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert list(r)[-1] == "check"
    assert r["check"]["bad_lines"] == {"value": 0, "limit": 0}


def test_traced_run_reports_stages():
    r = tiny(trace=1, seed=12)
    assert r["correct"] is True
    m = r["metrics"]
    assert {"setup.load_graph_s", "setup.index_s", "stage.chain_scan",
            "stage.polish", "rescue.rescued_pct"} <= set(m)
    # a device metric is never read from a CPU run
    assert not any(k.startswith(("kernel.", "device.")) for k in m)


def _answer_altered(orig):
    def align_batch(self, reads):
        out = orig(self, reads)
        for a in out:
            if a.ops is not None:
                k = np.flatnonzero(np.asarray(a.ops) == 0)
                if len(k):
                    a.ops = np.array(a.ops, copy=True)
                    a.ops[k[len(k) // 2]] = 3
        return out
    return align_batch


def _half_left_out(orig):
    def align_batch(self, reads):
        out = orig(self, reads)
        for a in out[::2]:
            a.positions = np.zeros((0, 2), dtype=np.int64)
            a.ops = None
        return out
    return align_batch


@pytest.mark.parametrize("fault", [_answer_altered, _half_left_out])
def test_broken_program_is_not_correct(monkeypatch, fault):
    from graphchainer_torch.models.chainer import ChainerModel
    monkeypatch.setattr(ChainerModel, "align_batch",
                        fault(ChainerModel.align_batch))
    r = tiny(seed=13)
    assert r["correct"] is False


def test_control_is_not_correct():
    """The repair returns its input unchanged (the configuration's control
    switch): the alignments keep the bubbles' wrong alleles."""
    r = tiny(seed=14, seconds=6, control=True)
    assert r["correct"] is False
    assert r["check"]["excess_ed"]["value"] \
        > r["check"]["excess_ed"]["limit"]


def test_harness_and_reference_load_no_jax():
    code = ("import sys, io; sys.path.insert(0, %r)\n"
            "from gcbench import run\n"
            "run.main(['--workload', 'tiny.clr', '--seed', '15', "
            "'--seconds', '2', '--trace', '0'], dirs=[%r, run.GCBENCH], "
            "device='cpu', require_card=False, out=io.StringIO())\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
            % (run.ROOT, DATA))
    top = json.loads(subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True, timeout=600).stdout.strip().splitlines()[-1]
        .replace("'", '"'))
    assert "graphchainer_torch" in top
    assert not {"jax", "jaxlib", "flax", "graphchainer_tpu"} & set(top)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import gcbench.reference.check\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
            % run.ROOT)
    top = json.loads(subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True, timeout=120).stdout.strip().replace("'", '"'))
    assert not {"jax", "jaxlib", "flax", "graphchainer_tpu",
                "graphchainer_torch", "torch"} & set(top)


def test_no_result_once_jax_is_loaded(tmp_path):
    """A metric's reader that loads a module named like JAX's (planted
    ahead of the real reader): the run exits 1 and prints no result."""
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "mean_norm_ed.py").write_text(
        "import sys, types\n"
        "sys.modules['jaxlib.xla_client'] = types.ModuleType('x')\n"
        "def read(ctx):\n"
        "    return 1.0\n")
    code = ("import sys, io; sys.path.insert(0, %r)\n"
            "from gcbench import run\n"
            "out = io.StringIO()\n"
            "try:\n"
            "    run.main(['--workload', 'tiny.clr', '--seed', '17', "
            "'--seconds', '2', '--trace', '0'], dirs=[%r, %r, run.GCBENCH],"
            " device='cpu', require_card=False, out=out)\n"
            "finally:\n"
            "    sys.__stdout__.write('RESULT[' + out.getvalue() + ']')\n"
            % (run.ROOT, str(tmp_path), DATA))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 1, p.stderr[-2000:]
    assert "RESULT[]" in p.stdout
    assert "jaxlib" in p.stderr.splitlines()[-1]


@pytest.mark.gpu
def test_tiny_cell_on_the_card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = tiny(seed=16, seconds=5, trace=1, device="cuda")
    assert r["correct"] is True
    assert r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0
    assert "kernel.frag_core_roofline" in r["metrics"]
