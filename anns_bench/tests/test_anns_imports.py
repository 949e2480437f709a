"""Whole top-level module names: a run loads none of jax, jaxlib, flax,
ml_dtypes or the JAX package, and the reference, the judge, the client
copies and the control load nothing of the program. prefhetch_tpu_torch
begins with prefhetch_tpu, so names are compared whole, never by prefix."""

import json
import os
import subprocess
import sys

from anns_bench.cell import ROOT
from anns_bench.run import FORBIDDEN, forbidden_modules


def _top_level_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_whole_names_not_prefixes(monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "prefhetch_tpu_torch.probe", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "prefhetch_tpu.probe", sys)
    assert forbidden_modules() == ["prefhetch_tpu"]


def test_a_run_loads_nothing_forbidden():
    names = _top_level_after(
        "from anns_bench.tests.small import small_cell\n"
        "from anns_bench import run\n"
        "out = run.execute(small_cell('sift1m-ivfpq-triage.search-b64'), 9, 0.5,"
        " False, device='cpu')\n"
        "assert out['attempted'] > 0, out\n")
    assert "prefhetch_tpu_torch" in names
    assert not names & set(FORBIDDEN)


def test_reference_side_loads_nothing_of_the_program():
    names = _top_level_after(
        "import anns_bench.reference, anns_bench.judge, anns_bench.control\n"
        "import anns_bench.client.bfv, anns_bench.client.wire\n"
        "import anns_bench.client.ranking, anns_bench.data\n"
        "import anns_bench.stats, anns_bench.roofline, anns_bench.cell\n"
        "import anns_bench.traffic\n")
    assert not names & ({"prefhetch_tpu_torch"} | set(FORBIDDEN))
