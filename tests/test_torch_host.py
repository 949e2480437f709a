"""Port parity: host-side copies, the import boundary and the device rule.

The port's numpy-only modules are copies of the JAX package's; the same seed
or input must give identical arrays and bytes. The port must import without
JAX, and its entry points must refuse to fall back to the CPU silently."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from prefhetch_tpu import metrics as j_metrics
from prefhetch_tpu.data import io as j_io
from prefhetch_tpu.data import synthetic as j_syn
from prefhetch_tpu.utils import wire_bin as j_wire
from prefhetch_tpu.utils.config import IndexParams as JIndexParams
from prefhetch_tpu_torch import metrics as t_metrics
from prefhetch_tpu_torch.data import io as t_io
from prefhetch_tpu_torch.data import synthetic as t_syn
from prefhetch_tpu_torch.utils import wire_bin as t_wire
from prefhetch_tpu_torch.utils.config import IndexParams as TIndexParams

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("gen", [
    "make_clustered_dataset", "make_hard_dataset", "make_angular_dataset",
])
def test_synthetic_same_seed_same_arrays(gen):
    kw = dict(nbase=500, ntrain=300, nquery=7, d=16, n_clusters=9, gt_k=5,
              seed=11)
    a = getattr(j_syn, gen)(**kw)
    b = getattr(t_syn, gen)(**kw)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kw", [
    {}, dict(d=128, nlist=1024, pq_m=32, pq_nbits=8), dict(pq_m=0),
    dict(quantizer="sq8"), dict(metric="cosine", balance=1.25),
])
def test_artifact_name_identical(kw):
    assert JIndexParams(**kw).artifact_name() == \
        TIndexParams(**kw).artifact_name()


def test_fvecs_ivecs_cross_read(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(13, 24)).astype(np.float32)
    ids = rng.integers(0, 1000, size=(13, 5)).astype(np.int32)
    j_io.write_fvecs(str(tmp_path / "a.fvecs"), x)
    t_io.write_ivecs(str(tmp_path / "b.ivecs"), ids)
    np.testing.assert_array_equal(t_io.read_fvecs(str(tmp_path / "a.fvecs")),
                                  x)
    np.testing.assert_array_equal(j_io.read_ivecs(str(tmp_path / "b.ivecs")),
                                  ids)
    d, n, flat = t_io.vecs_read(str(tmp_path / "a.fvecs"))
    assert (d, n) == (24, 13)
    np.testing.assert_array_equal(flat, x.reshape(-1))


def test_metrics_identical():
    rng = np.random.default_rng(1)
    gt = rng.integers(0, 200, size=(9, 100))
    obs = np.where(rng.random((9, 100)) < 0.5, gt, rng.integers(0, 200,
                                                                (9, 100)))
    assert j_metrics.benchmark_results(obs, gt).as_dict() == \
        t_metrics.benchmark_results(obs, gt).as_dict()


def test_wire_bin_cross_decode():
    secs = [np.arange(12, dtype=np.float32).reshape(3, 4),
            np.arange(6, dtype=np.int64).reshape(3, 2),
            np.array([7], np.uint32)]
    buf = t_wire.encode(t_wire.KIND_SEARCH_REQ, secs)
    assert buf == j_wire.encode(j_wire.KIND_SEARCH_REQ, secs)
    kind, got = j_wire.decode(buf)
    assert kind == j_wire.KIND_SEARCH_REQ
    for a, b in zip(secs, got):
        np.testing.assert_array_equal(a, b)


def test_port_imports_without_jax():
    """Every module of the port and chip_smoke.py import with jax, flax,
    ml_dtypes and the JAX package blocked."""
    mods = sorted(
        "prefhetch_tpu_torch." + ".".join(p.relative_to(
            ROOT / "prefhetch_tpu_torch").with_suffix("").parts)
        for p in (ROOT / "prefhetch_tpu_torch").rglob("*.py")
        if p.name != "__init__.py"
    )
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'ml_dtypes', 'prefhetch_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        "import prefhetch_tpu_torch, chip_smoke\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_name_no_jax():
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|ml_dtypes|prefhetch_tpu)\b",
        re.M,
    )
    files = list((ROOT / "prefhetch_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        assert not pat.search(f.read_text()), f


def test_default_device_without_cuda_raises(monkeypatch):
    from prefhetch_tpu_torch.device import resolve_device
    from prefhetch_tpu_torch.engine.server import QueryEngine
    from prefhetch_tpu_torch.index.build import build_ivf_index
    from prefhetch_tpu_torch.utils.config import PipelineConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        QueryEngine(PipelineConfig())
    x = np.zeros((64, 8), np.float32)
    with pytest.raises(RuntimeError):
        build_ivf_index(x, x, TIndexParams(d=8, nlist=4, pq_m=0))
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_kernel_wrapper_cpu_takes_plain_version():
    """A CPU tensor goes to the plain version; only a CUDA tensor may launch
    the kernel (which a machine without nvcc cannot build)."""
    from prefhetch_tpu_torch.ops import union_scan_min as usm

    rng = np.random.default_rng(2)
    payload = torch.from_numpy(
        rng.integers(0, 256, (3, 64, 16)).astype(np.float32))
    norms = (payload ** 2).sum(-1)
    sizes = torch.tensor([64, 5, 0], dtype=torch.int32)
    q = torch.from_numpy(rng.integers(0, 256, (4, 16)).astype(np.float32))
    union = torch.tensor([1, 0, 2, 2], dtype=torch.int32)
    launches = usm.union_scan_min.launches
    calls = usm.union_scan_min_reference.calls
    d2, dmin = usm.union_scan_min(payload, norms, sizes, q, union)
    assert usm.union_scan_min.launches == launches
    assert usm.union_scan_min_reference.calls == calls + 1
    assert d2.shape == (4, 4, 64) and d2.dtype == torch.bfloat16
    assert dmin.shape == (4, 1, 4) and dmin.dtype == torch.float32
    # size-0 tile: PAD rows (+inf in bf16) and a PAD minimum
    assert torch.isinf(d2[2]).all() and (dmin[2] == 3.4e38).all()
    assert torch.isinf(d2[0, :, 5:]).all() and torch.isfinite(d2[0, :, :5]).all()
