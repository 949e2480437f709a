"""The port's benchmark (``python -m prefhetch_tpu_torch.bench``) against
the JAX repo's ``bench.py`` on the CPU, at a small PFH_BENCH_NBASE.

bench.py is loaded as the reference with importlib (PFH_KEEP_THP=1, so its
import changes nothing process-wide) and its CACHE pointed at a test
directory; its ``main`` runs in a subprocess, since it arms signal handlers
and deletes every live JAX array between sections. Nothing in bench.py
changes. The port's ``main`` runs in this process with ``--device cpu``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import pathlib
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from prefhetch_tpu_torch.bench import __main__ as bench_main
from prefhetch_tpu_torch.bench import core as bench_core
from prefhetch_tpu_torch.bench import data as bench_data
from prefhetch_tpu_torch.bench.encrypted import (
    encrypted_rerank_qps, pad_candidates,
)
from prefhetch_tpu_torch.client.he import HEClient
from prefhetch_tpu_torch.index.build import load_index
from prefhetch_tpu_torch.utils.config import HEParams

ROOT = pathlib.Path(__file__).resolve().parent.parent
NBASE = 4096
# tiles of 64 slots: small lists fill them, which keeps the CPU scans short
SETTINGS = {"PFH_BENCH_NBASE": str(NBASE), "PFH_BENCH_TILE": "64"}
# queries a step, for both programs: the headline and pq score recall on
# one step's queries
BATCH = "64"
# the sections run here besides the headline; the rest are left out
RUN = ("pq", "angular", "hard")
SKIP = {var: "1" for name, var in bench_data.SECTIONS if name not in RUN}
# keys only one of the two programs prints, each for its reason
JAX_ONLY = {
    # the Pallas/XLA form a section ran; on the card always the kernel
    "pq_formulation", "angular_scan_formulation", "hard_scan_formulation",
}
PORT_ONLY = {
    "skipped", "failed", "section_s", "device", "dev_batch",
    # numpy_pipeline's recall beside each device recall, on the same
    # queries and index
    *(f"{p}numpy_recall_{at}" for p in ("", "pq_", "angular_", "hard_")
      for at in ("at_10", "at_100", "gap_at_100")),
}


def load_jax_bench(monkeypatch, cache):
    """bench.py as a module at NBASE, its cache in ``cache``."""
    monkeypatch.setenv("PFH_KEEP_THP", "1")
    monkeypatch.setenv("PFH_BENCH_NBASE", str(NBASE))
    spec = importlib.util.spec_from_file_location("jax_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.CACHE = str(cache)
    return mod


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """bench.py's main in a subprocess, started at once and read when a
    test needs it: (its result line, its cache directory)."""
    cache = tmp_path_factory.mktemp("jax_bench_cache")
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('jax_bench', "
        "sys.argv[1])\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        "m.CACHE = sys.argv[2]\n"
        "m.main()\n"
    )
    env = {**os.environ, **SETTINGS, **SKIP, "PFH_BENCH_BATCH": BATCH,
           "PFH_KEEP_THP": "1", "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen(
        [sys.executable, "-c", code, str(ROOT / "bench.py"), str(cache)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=ROOT,
    )
    done = {}

    def result():
        if not done:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err.decode()[-3000:]
            done["line"] = json.loads(out.decode().strip().splitlines()[-1])
        return done["line"], cache

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=60)


def run_port(argv, env: dict) -> tuple:
    """The port's main in this process: (exit code, the line or None)."""
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        with contextlib.redirect_stdout(out):
            code = bench_main.main(argv)
    lines = out.getvalue().strip().splitlines()
    assert len(lines) <= 1
    return code, (json.loads(lines[0]) if lines else None)


@pytest.fixture(scope="module")
def port_run(jax_run, tmp_path_factory):
    """The port's bench on the CPU (while bench.py's runs): (exit code,
    line, cache)."""
    cache = tmp_path_factory.mktemp("port_bench_cache")
    code, line = run_port(["--device", "cpu", "--cache", str(cache)],
                          {**SETTINGS, **SKIP, "PFH_BENCH_BATCH": BATCH})
    return code, line, cache


def test_core_and_pipeline_sections_on_cpu(port_run):
    """The headline, pq, angular and hard on the CPU: exit 0, every
    device recall@100 within RECALL_GAP of numpy_pipeline's on the same 64
    queries and index, hard's under its exact-IVF oracle."""
    code, line, _ = port_run
    assert code == 0
    e = line["extra"]
    assert e["status"] == "complete" and e["failed"] == []
    assert e["skipped"] == ["encrypted", "http", "ckks", "pir"]
    assert e["backend"] == "cpu" and e["device"] == "cpu"
    assert line["value"] > 0 and line["vs_baseline"] > 0
    for prefix in ("", "pq_", "angular_", "hard_"):
        gap = e[f"{prefix}numpy_recall_gap_at_100"]
        assert abs(gap) <= bench_core.RECALL_GAP
        assert (e[f"{prefix}recall_at_100"]
                == pytest.approx(e[f"{prefix}numpy_recall_at_100"] + gap))
    assert e["hard_recall_at_100"] <= e["hard_oracle_recall_at_100"]
    assert [(f["nprobe"], f["coarse_probe"]) for f in e["hard_frontier"]] \
        == list(bench_core.FRONTIER)
    assert set(e["section_s"]) == {"core", *RUN}


def test_line_keys_equal_bench_py(port_run, jax_run):
    """The same keys as bench.py's line for the sections run, but for the
    ones only one of them prints (JAX_ONLY, PORT_ONLY)."""
    _, line, _ = port_run
    jline, _ = jax_run()
    assert set(line) == set(jline)
    jkeys, pkeys = set(jline["extra"]), set(line["extra"])
    assert JAX_ONLY <= jkeys and PORT_ONLY <= pkeys
    assert pkeys - PORT_ONLY == jkeys - JAX_ONLY
    assert set(line["extra"]["stage_ms"]) == set(jline["extra"]["stage_ms"])
    assert [set(f) for f in line["extra"]["hard_frontier"]] \
        == [set(f) for f in jline["extra"]["hard_frontier"]]


# the recall figures of the sections run; bench.py prints them to 4 places
RECALL_KEYS = ("recall_at_10", "recall_at_100", "pq_recall_at_10",
               "pq_recall_at_100", "angular_recall_at_10",
               "angular_recall_at_100", "hard_recall_at_10",
               "hard_recall_at_100", "hard_oracle_recall_at_10",
               "hard_oracle_recall_at_100", "hard_best_recall_at_100")


def test_recall_equal_to_bench_py(port_run, jax_run):
    """At the same size, batch and tiles, every recall figure (and the hard
    frontier's) is bench.py's: the same datasets, an index built the same
    way, the same ranking."""
    e = port_run[1]["extra"]
    je = jax_run()[0]["extra"]
    for key in RECALL_KEYS:
        assert e[key] == pytest.approx(je[key], abs=5e-5), key
    assert [f["recall_at_100"] for f in e["hard_frontier"]] == pytest.approx(
        [f["recall_at_100"] for f in je["hard_frontier"]], abs=5e-5)


@pytest.mark.parametrize("which", ["main", "hard", "angular"])
def test_datasets_bit_equal_to_bench_py(port_run, jax_run, monkeypatch,
                                        which):
    """The three datasets, as bench.py's get_*_dataset gives them (from its
    run's cache) and as the port's does (from its own)."""
    _, jcache = jax_run()
    jb = load_jax_bench(monkeypatch, jcache)
    cfg = bench_data.BenchConfig(nbase=NBASE, cache=str(port_run[2]))
    getters = {"main": ("get_dataset", "get_dataset"),
               "hard": ("get_hard_dataset", "get_hard_dataset"),
               "angular": ("get_angular_dataset", "get_angular_dataset")}
    jname, pname = getters[which]
    want = getattr(jb, jname)()
    got = getattr(bench_data, pname)(cfg)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


def test_numpy_references_bit_equal_to_bench_py(jax_run, monkeypatch):
    """numpy_pipeline and ivf_oracle_topk give bench.py's ids on bench.py's
    index, carried across with the port's npz reader."""
    _, jcache = jax_run()
    jb = load_jax_bench(monkeypatch, jcache)
    data = jb.get_dataset()
    jindex = jb.get_index(data)            # bench.py's cached JAX index
    path = next(jcache.glob(f"N{NBASE}_*.npz"))
    pindex = load_index(str(path), device="cpu")
    queries = data["query"][:8].astype(np.float32)
    np.testing.assert_array_equal(
        bench_data.numpy_pipeline(pindex, data["base"])(queries),
        jb.numpy_pipeline(jindex, data["base"], queries)(queries))
    np.testing.assert_array_equal(
        bench_data.ivf_oracle_topk(data, pindex),
        jb._ivf_oracle_topk(data, jindex))
    ids = np.arange(12).reshape(2, 6) * 7 + NBASE - 20
    np.testing.assert_array_equal(pad_candidates(ids, 9, NBASE),
                                  jb._pad_candidates(ids, 9, NBASE))


def test_encrypted_rerank_decrypts_exact_distances(port_run):
    """The packed BFV re-rank at 4 queries on the CPU: every decryption
    exact (it raises otherwise), the rates positive, and the program run
    again on its inputs."""
    _, _, cache = port_run
    cfg = bench_data.BenchConfig(nbase=NBASE, cache=str(cache))
    data = bench_data.get_dataset(cfg)
    cand = np.arange(4 * 100).reshape(4, 100) % NBASE
    e2e, mac, kernel, svc = encrypted_rerank_qps(data, cand,
                                                 torch.device("cpu"), nq=4)
    assert min(e2e, mac, kernel) > 0
    assert svc.device == torch.device("cpu")
    # the kernel rate's program_repeat: the same device result again
    hc = HEClient(HEParams(resp_mod="packed"), seed=11)
    svc.register_galois_keys(hc.key_id, hc.bfv_extraction_keys_wire(128))
    pending = svc.encrypted_scores_packed_wire_async(
        hc.encrypt_query_batch(data["query"][:4].astype(np.float32)),
        pad_candidates(cand, 256, NBASE), hc.key_id)
    assert torch.equal(pending.program_repeat(), pending.dev_out)


@pytest.mark.parametrize("mode", ["gather", "host", "device"])
def test_ckks_program_repeat_equals_the_first_run(mode):
    """DeviceCKKS's combined resolver runs the device work again on its
    uploaded inputs (ckks_device_qps) and gets the same result: parked-base
    gather, host encode and device encode, on seedTf wires at N=256."""
    from prefhetch_tpu_torch.crypto import ckks
    from prefhetch_tpu_torch.crypto.params import CKKSParams, find_ntt_primes
    from prefhetch_tpu_torch.engine.ckks_device import DeviceCKKS

    n, d, nq = 256, 32, 2
    params = CKKSParams(n=n, scale_bits=26,
                        qs=tuple(find_ntt_primes(n, 30, 3)))
    ctx = ckks.CKKSContext(params)
    rng = np.random.default_rng(3)
    sk, _ = ctx.keygen(rng)
    gks = ctx.galois_keygen(
        sk, ckks.rotation_steps(d) + ctx.combine_tree_steps(4, d), rng)
    svc = DeviceCKKS(params, device="cpu")
    svc.register_keys("k", {str(s): g.to_wire() for s, g in gks.items()})
    base = rng.integers(0, 30, (50, d)).astype(np.float32)
    ids = np.stack([rng.permutation(50)[:10] for _ in range(nq)]).astype(
        np.int32)
    wires = [ctx.encrypt_symmetric_tf(
        sk, ctx.encode(np.tile(base[i], (n // 2) // d)), rng)
        for i in range(nq)]
    if mode == "gather":
        svc.set_base(base)
        pending = svc.encrypted_scores_combined_batch_async(wires, ids, "k")
    else:
        pending = svc.encrypted_scores_combined_batch_async(
            wires, base[ids].astype(np.float64), "k",
            dev_encode=mode == "device")
    assert torch.equal(pending.program_repeat(), pending.dev_out)


@pytest.mark.parametrize("how", ["raises", "deadline"])
def test_failed_section_fails_the_run(port_run, monkeypatch, how):
    """A section that raises, or that the deadline leaves no time for,
    gets <name>_error in the line and exit code 1; the PFH_BENCH_SKIP_*
    sections are listed under extra.skipped."""
    _, _, cache = port_run
    env = {**SETTINGS, "PFH_BENCH_BATCH": "16",
           **{var: "1" for name, var in bench_data.SECTIONS
              if name != "pq"}}
    if how == "raises":
        def boom(*a, **k):
            raise RuntimeError("made to fail")

        monkeypatch.setattr(bench_core, "run_pq", boom)
    else:
        env["PFH_BENCH_DEADLINE_S"] = "60"     # pq's estimate is 120 s
    code, line = run_port(["--device", "cpu", "--cache", str(cache)], env)
    assert code == 1
    e = line["extra"]
    assert e["status"] == "failed" and e["failed"] == ["pq"]
    assert ("made to fail" if how == "raises" else "deadline") \
        in e["pq_error"]
    assert "pq_onehot_qps" not in e
    assert e["skipped"] == ["encrypted", "http", "ckks", "pir", "angular",
                            "hard"]
    assert line["value"] > 0 and "recall_at_100" in e


def _plant(monkeypatch, plant: str) -> tuple:
    """Make one answer of the bench wrong; returns (the section that must
    fail, a phrase of its error)."""
    def shift(ids):
        return (np.asarray(ids) + 1) % NBASE

    if plant == "core ids":
        real = bench_core.timed_qps

        def shifted(*a, **k):
            qps, ids = real(*a, **k)
            return qps, shift(ids)

        monkeypatch.setattr(bench_core, "timed_qps", shifted)
        return "core", "numpy_pipeline"
    if plant == "pq ids":
        real_pipe = bench_core.pipeline

        def pipe(*a, quant=None, **k):
            step, args, stats = real_pipe(*a, quant=quant, **k)
            if quant != "pq":
                return step, args, stats

            def wrong(*sa):
                d, ids = step(*sa)
                return d, torch.as_tensor(shift(ids.cpu().numpy()))

            return wrong, args, stats

        monkeypatch.setattr(bench_core, "pipeline", pipe)
        return "pq", "numpy_pipeline"
    real_oracle = bench_core.ivf_oracle_topk
    monkeypatch.setattr(bench_core, "ivf_oracle_topk",
                        lambda *a, **k: shift(real_oracle(*a, **k)))
    return "hard", "exact-IVF oracle"


@pytest.mark.parametrize("plant", ["core ids", "pq ids", "hard oracle"])
def test_planted_wrong_answer_fails_its_section(port_run, monkeypatch,
                                                 plant):
    """A wrong answer planted in a section (ids shifted by one row, or an
    oracle that ranks wrong) fails that section's check: <name>_error in
    the line, its figures left out, exit code 1."""
    _, _, cache = port_run
    section, phrase = _plant(monkeypatch, plant)
    run = ("pq", "hard")
    env = {**SETTINGS, "PFH_BENCH_BATCH": "16",
           **{var: "1" for name, var in bench_data.SECTIONS
              if name not in run}}
    code, line = run_port(["--device", "cpu", "--cache", str(cache)], env)
    assert code == 1
    e = line["extra"]
    assert phrase in e[f"{section}_error"]
    assert [k for k in e if k.endswith("_error")] == [f"{section}_error"]
    figure = {"core": "recall_at_100", "pq": "pq_recall_at_100",
              "hard": "hard_recall_at_100"}[section]
    assert figure not in e
    if section != "core":               # a failed headline ends the run
        assert e["failed"] == [section]


def test_flipped_decrypted_distance_fails_the_check(port_run, monkeypatch):
    """One decrypted BFV distance off by one: encrypted_rerank_qps raises
    CheckFailed (so its section fails)."""
    _, _, cache = port_run
    cfg = bench_data.BenchConfig(nbase=NBASE, cache=str(cache))
    data = bench_data.get_dataset(cfg)
    real = HEClient.decrypt_scores_packed

    def flipped(self, *a, **k):
        out = np.array(real(self, *a, **k))
        out[1, 7] += 1
        return out

    monkeypatch.setattr(HEClient, "decrypt_scores_packed", flipped)
    cand = np.arange(4 * 100).reshape(4, 100) % NBASE
    with pytest.raises(bench_core.CheckFailed, match="off by 1"):
        encrypted_rerank_qps(data, cand, torch.device("cpu"), nq=4)


def test_wrong_pir_row_fails_the_check():
    """A PIR row decoded with one value off fails the row check."""
    from prefhetch_tpu_torch.bench.pir import _check_rows

    base = np.arange(3 * 128, dtype=np.float32).reshape(3, 128)

    class Client:
        def __init__(self, wrong_row):
            self.wrong_row = wrong_row

        def decode_response_2d(self, resp, d, rad):
            row = np.round(base[resp]).astype(np.int64)
            if resp == self.wrong_row:
                row[5] ^= 1
            return row

    _check_rows(Client(None), [0, 2], [None] * 2, [0, 2], base)
    with pytest.raises(bench_core.CheckFailed, match="row 2"):
        _check_rows(Client(2), [0, 2], [None] * 2, [0, 2], base)


def test_signal_prints_the_line_and_exits_128_plus_signum(port_run):
    """SIGTERM mid-run: the line so far with aborted_by, exit 143."""
    _, _, cache = port_run
    env = {**os.environ, **SETTINGS, "PFH_BENCH_BATCH": "16",
           "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "prefhetch_tpu_torch.bench", "--device",
         "cpu", "--cache", str(cache)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=ROOT,
    )
    try:
        for raw in proc.stderr:             # handlers are armed by now
            if raw.startswith(b"[bench] "):
                break
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    assert proc.returncode == 128 + signal.SIGTERM
    line = json.loads(out.decode().strip().splitlines()[-1])
    assert line["extra"]["aborted_by"] == "SIGTERM"
    assert line["metric"] == "ivfpq_query_pipeline_qps"


def test_without_cuda_exits_2_and_prints_no_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_main.main([]) == 2
    assert capsys.readouterr().out == ""


def test_make_dataset_tool_writes_the_jax_scripts_bytes(tmp_path):
    """tools/make_dataset.py and scripts/make_dataset.py, same arguments:
    the same four files byte for byte."""
    from prefhetch_tpu_torch.tools import make_dataset

    args = ["--prefix", "tiny", "--nbase", "500", "--ntrain", "300",
            "--nquery", "7", "--d", "16", "--clusters", "9", "--seed", "5"]
    for hard in ([], ["--hard"]):
        jdir, pdir = tmp_path / f"jax{len(hard)}", tmp_path / f"port{len(hard)}"
        subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "make_dataset.py"),
             "--out", str(jdir), *args, *hard],
            check=True, capture_output=True, cwd=ROOT, timeout=300,
            env={**os.environ, "JAX_PLATFORMS": "cpu",
                 "PYTHONPATH": str(ROOT)},
        )
        make_dataset.main(["--out", str(pdir), *args, *hard])
        names = sorted(p.name for p in jdir.iterdir())
        assert len(names) == 4 and names == sorted(
            p.name for p in pdir.iterdir())
        for n in names:
            assert (pdir / n).read_bytes() == (jdir / n).read_bytes(), n
