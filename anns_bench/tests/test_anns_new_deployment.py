"""A deployment is added as new files only: a configuration, a traffic mix,
a route with a judge of its own, a data generator and an entry, all written
into a copy of the harness's directories, run small on the CPU through
``run.execute`` and come out correct, with no file of the copy edited."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from anns_bench.cell import HERE, ROOT

CONFIG = {
    "name": "blobs-coarse",
    "source": "a test deployment",
    "dataset": {"generator": "blobs", "nbase": 4096, "ntrain": 4096,
                "nquery": 256, "d": 128, "n_clusters": 8, "spread": 12.0,
                "value_max": 255, "corpus_seed": 5},
    "index": {"nlist": 16, "pq_m": 32, "pq_nbits": 8, "balance": 0.0},
    "protocol": {"nprobe": 8, "coarse_probe": 256, "k": 100},
    "he": None,
    "checks": {"failed": 0, "id_faults": 0, "recall_at_100_min": 0.7},
}
MIX = {"route": "coarse-only", "entry": "counting", "rows_per_request": 32,
       "clients": 1, "warm_requests": 2}

GENERATOR = '''
import numpy as np
import torch


def generate(spec, seed, device):
    """Integer Gaussian blobs: the corpus from corpus_seed, the queries
    from the run's seed."""
    d, nc = int(spec["d"]), int(spec["n_clusters"])
    vmax = float(spec["value_max"])

    def gen(s):
        g = torch.Generator(device=device)
        g.manual_seed(int(s) % (1 << 63))
        return g

    g = gen(spec["corpus_seed"])
    centers = torch.rand((nc, d), generator=g, device=device) * vmax

    def sample(n, g):
        which = torch.randint(0, nc, (n,), generator=g, device=device)
        x = torch.randn((n, d), generator=g, device=device) * spec["spread"]
        return (x + centers[which]).round_().clamp_(0, vmax).cpu().numpy()

    return {"base": sample(int(spec["nbase"]), g),
            "train": sample(int(spec["ntrain"]), g),
            "query": sample(int(spec["nquery"]), gen(seed))}
'''

ENTRY = '''
CALLS = []


class Entry:
    """Dispatcher.handle in process, counting the requests it carries."""

    def __init__(self, system):
        self._handle = system.handle

    def handle(self, method, path, headers, body):
        CALLS.append(path)
        return self._handle(method, path, headers, body)

    def close(self):
        self._handle = None
'''

ROUTE = '''
import numpy as np

from anns_bench.client import wire
from anns_bench.judge import _hits, _id_faults, _recall
from anns_bench.reference import bf16_topk
from anns_bench.traffic import BIN, Traffic


class Route(Traffic):
    """The coarse round alone: a binary top-COARSE_PROBE /coarsesearch."""

    def _prepare(self):
        n = len(self.queries)
        self.batch_rows = [(b * self.rows + np.arange(self.rows)) % n
                           for b in range(-(-n // self.rows))]
        self.bodies = [wire.encode(wire.KIND_COARSE_TOPK_REQ, [
            self.queries[r], self.probes[r],
            np.asarray([self.coarse_probe], np.uint32)])
            for r in self.batch_rows]

    def _items(self, c):
        return list(range(len(self.bodies)))

    def _send(self, c, item, first=False):
        st, _, resp = self.handle("POST", "/coarsesearch", BIN,
                                  self.bodies[item])
        return st == 200, resp

    @property
    def width(self):
        return self.coarse_probe

    def _decode(self, r):
        kind, secs = wire.decode(r.answer)
        if kind != wire.KIND_COARSE_TOPK:
            raise ValueError("not a top-k answer")
        return (self.batch_rows[r.item], secs[0].astype(np.int64),
                secs[1].astype(np.float64))


def judge(ref, queries, qidx, ids, dist, failed, k):
    """The share of the exact top k among the candidates."""
    faults = _id_faults(ids, ref.base.shape[0]) if len(ids) else 0
    uq = np.unique(qidx)
    truth = ref.exact_topk(queries[uq], k)[np.searchsorted(uq, qidx)]
    recall = _recall(qidx, _hits(ids, truth), k)
    return ({"failed": float(failed), "id_faults": float(faults),
             "recall_at_100": recall}, recall)


def answered(mix, n_pool):
    return np.arange(n_pool)


def control(ref, queries, config):
    return bf16_topk(ref, queries, int(config["protocol"]["coarse_probe"]))
'''

RUN = '''
import json
from anns_bench import run
from anns_bench.cell import cell_from_files
import anns_bench.entries.counting as entry

cell = cell_from_files("blobs-coarse.coarse-b32", "blobs-coarse", "coarse-b32",
                       1, [{"name": n, "unit": "u"} for n in
                           ("qps", "recall_at_100", "setup_s")], [])
out = run.execute(cell, 2**31 + 3, 0.5, False, device="cpu")
print(json.dumps({"correct": out["correct"], "checks": out["checks"],
                  "attempted": out["attempted"],
                  "paths": sorted(set(entry.CALLS)),
                  "metrics": sorted(out["metrics"]), "file": run.__file__}))
'''


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_a_deployment_added_as_files_runs_correct(tmp_path):
    copy = tmp_path / "anns_bench"
    shutil.copytree(HERE, copy, ignore=shutil.ignore_patterns(
        ".cache", ".scratch", "__pycache__"))
    before = _digests(copy)
    new = {"configs/blobs-coarse.json": json.dumps(CONFIG),
           "workloads/coarse-b32.json": json.dumps(MIX),
           "generators/blobs.py": GENERATOR,
           "entries/counting.py": ENTRY,
           "routes/coarse_only.py": ROUTE}
    for rel, text in new.items():
        assert rel not in before
        (copy / rel).write_text(text)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["file"].startswith(str(copy))
    assert out["attempted"] > 0 and out["paths"] == ["/coarsesearch",
                                                     "/query"]
    assert out["correct"], out["checks"]
    assert out["metrics"] == ["qps", "recall_at_100", "setup_s"]
    after = _digests(copy)
    assert {k: after[k] for k in before} == before
