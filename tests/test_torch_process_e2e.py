"""Two processes at the reference's file layout, with the port as the server:
``python -m prefhetch_tpu_torch.serve.main --device cpu`` (threaded and
native frontends) against the JAX package's client driver and the port's
own. Each driver's printed recall/MRR block must equal, to 1e-9, the block
of the JAX client pipeline run in-process against the same server, as
tests/test_process_e2e.py holds the JAX server. A server asked for CUDA
where there is none refuses to start. Servers are stopped by kill(), never
by a signal they might ignore."""

import json
import os
import re
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCK_RE = (
    re.compile(r"Recall@1 = ([\d.eE+-]+), Recall@10 = ([\d.eE+-]+), "
               r"Recall@100 = ([\d.eE+-]+)"),
    re.compile(r"MRR@1 = ([\d.eE+-]+), MRR@10 = ([\d.eE+-]+), "
               r"MRR@100 = ([\d.eE+-]+)"),
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sub_env(**extra):
    env = dict(os.environ)
    env["PFH_PLATFORM"] = "cpu"
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO_ROOT
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def disk_layout(tmp_path_factory):
    """The reference's four files, a config, and the port's index built
    once into the index directory (each server warm-loads it)."""
    from prefhetch_tpu_torch.data.synthetic import write_sift_style_dataset
    from prefhetch_tpu_torch.engine.server import QueryEngine
    from prefhetch_tpu_torch.utils.config import PipelineConfig

    ds = tmp_path_factory.mktemp("refds")
    paths = write_sift_style_dataset(
        str(ds), prefix="siftsyn", nbase=3000, ntrain=4000, nquery=16,
        d=24, n_clusters=24, gt_k=100, seed=31,
    )
    cfg = {
        "index": {"d": 24, "nlist": 12, "pq_m": 6, "pq_nbits": 8,
                  "kmeans_iters": 5, "pq_kmeans_iters": 5},
        "protocol": {"nprobe": 4, "coarse_probe": 120, "k": 100,
                     "nquery": 5},
        "nbase": 3000,
        "train_path": paths["train"],
        "base_path": paths["base"],
        "query_path": paths["query"],
        "groundtruth_path": paths["groundtruth"],
    }
    cfg_path = os.path.join(str(ds), "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    idx_dir = str(tmp_path_factory.mktemp("idx"))
    with open(cfg_path) as f:
        engine = QueryEngine(PipelineConfig.from_json(f.read()),
                             index_dir=idx_dir, device="cpu")
    engine.init_index()
    return cfg_path, idx_dir


def _wait_up(srv, port, deadline_s=180):
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        if srv.poll() is not None:
            out = srv.stdout.read().decode(errors="replace")
            raise AssertionError(f"server died:\n{out[-2000:]}")
        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=2
            ) as r:
                if r.status == 200:
                    return
        except OSError:
            time.sleep(0.3)
    raise AssertionError(f"server did not come up in {deadline_s} s")


def _block(out: str):
    m_r, m_m = (r.search(out) for r in _BLOCK_RE)
    assert m_r and m_m, f"no recall/MRR block in driver output:\n{out}"
    return [float(x) for x in m_r.groups() + m_m.groups()]


@pytest.mark.parametrize("frontend", ["threaded", "native"])
def test_drivers_against_the_port_server(disk_layout, frontend):
    from prefhetch_tpu.client.pipeline import ClientPipeline
    from prefhetch_tpu.data.io import read_ivecs
    from prefhetch_tpu.metrics import benchmark_results
    from prefhetch_tpu.utils.config import PipelineConfig

    cfg_path, idx_dir = disk_layout
    port = _free_port()
    srv = subprocess.Popen(
        [sys.executable, "-m", "prefhetch_tpu_torch.serve.main",
         "--config", cfg_path, "--port", str(port), "--index-dir", idx_dir,
         "--frontend", frontend, "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=_sub_env(),
        cwd=REPO_ROOT,
    )
    try:
        _wait_up(srv, port)
        addr = f"http://127.0.0.1:{port}/"
        with open(cfg_path) as f:
            pcfg = PipelineConfig.from_json(f.read())
        _, top_ids = ClientPipeline(pcfg, server_addr=addr).run()
        rep = benchmark_results(top_ids, read_ivecs(pcfg.groundtruth_path),
                                k=pcfg.protocol.k)
        want = [rep.recall_1, rep.recall_10, rep.recall_100, rep.mrr_1,
                rep.mrr_10, rep.mrr_100]
        assert rep.recall_10 > 0.5
        for pkg in ("prefhetch_tpu", "prefhetch_tpu_torch"):
            cli = subprocess.run(
                [sys.executable, "-m", f"{pkg}.client.driver",
                 "--config", cfg_path, "--server", addr],
                capture_output=True, env=_sub_env(), cwd=REPO_ROOT,
                timeout=300,
            )
            out = (cli.stdout + cli.stderr).decode(errors="replace")
            assert cli.returncode == 0, out[-2000:]
            assert "Time taken for client queries" in out
            np.testing.assert_allclose(_block(out), want, atol=1e-9,
                                       err_msg=pkg)
    finally:
        srv.kill()
        srv.wait(timeout=30)
        srv.stdout.close()


def test_server_asked_for_cuda_without_it_refuses(disk_layout):
    cfg_path, idx_dir = disk_layout
    port = _free_port()
    run = subprocess.run(
        [sys.executable, "-m", "prefhetch_tpu_torch.serve.main",
         "--config", cfg_path, "--port", str(port), "--index-dir", idx_dir,
         "--frontend", "threaded"],
        capture_output=True, env=_sub_env(CUDA_VISIBLE_DEVICES=""),
        cwd=REPO_ROOT, timeout=120,
    )
    assert run.returncode == 2
    assert b"torch.cuda.is_available() is False" in run.stderr
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                               timeout=2)
