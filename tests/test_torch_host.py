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
from prefhetch_tpu_torch.tools import kernel_ablation as ka
from prefhetch_tpu_torch.utils import cuda_build
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


def _port_sources():
    """The port's Python files; what a build or a smoke run leaves under
    prefhetch_tpu_torch/build/ is not the package."""
    pkg = ROOT / "prefhetch_tpu_torch"
    return [p for p in pkg.rglob("*.py")
            if p.relative_to(pkg).parts[0] != "build"]


def test_port_imports_without_jax():
    """Every module of the port and chip_smoke.py import with jax, flax,
    ml_dtypes and the JAX package blocked."""
    mods = sorted(
        "prefhetch_tpu_torch." + ".".join(p.relative_to(
            ROOT / "prefhetch_tpu_torch").with_suffix("").parts)
        for p in _port_sources() if p.name != "__init__.py"
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
    # the packed BFV wire's modules are among them, and the HTTP layers
    assert {"prefhetch_tpu_torch.ops.threefry",
            "prefhetch_tpu_torch.crypto.bfv",
            "prefhetch_tpu_torch.engine.hecompute",
            "prefhetch_tpu_torch.serve.http_server",
            "prefhetch_tpu_torch.serve.aio_server",
            "prefhetch_tpu_torch.serve.native_server",
            "prefhetch_tpu_torch.serve.batcher",
            "prefhetch_tpu_torch.serve.main",
            "prefhetch_tpu_torch.client.pipeline",
            "prefhetch_tpu_torch.client.binwire",
            "prefhetch_tpu_torch.client.driver",
            "prefhetch_tpu_torch.utils.timer",
            "prefhetch_tpu_torch.utils.logging",
            "prefhetch_tpu_torch.crypto.ckks",
            "prefhetch_tpu_torch.engine.ckks_device",
            "prefhetch_tpu_torch.crypto.pir",
            "prefhetch_tpu_torch.client.pir",
            "prefhetch_tpu_torch.engine.pir_device"} <= set(mods)


def test_http_routes_serve_without_jax(tmp_path):
    """One JSON /coarsesearch and one /precisesearch through a threaded
    server and the port's client, with jax, flax, ml_dtypes and the JAX
    package blocked: the codec's build and every import on the served path
    happen without them."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'ml_dtypes', 'prefhetch_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from prefhetch_tpu_torch.client.pipeline import ClientPipeline\n"
        "from prefhetch_tpu_torch.data.synthetic import "
        "write_sift_style_dataset\n"
        "from prefhetch_tpu_torch.engine.server import QueryEngine\n"
        "from prefhetch_tpu_torch.serve.http_server import serve_forever\n"
        "from prefhetch_tpu_torch.utils.config import (\n"
        "    IndexParams, PipelineConfig, ProtocolParams)\n"
        f"p = write_sift_style_dataset({str(tmp_path)!r}, prefix='s', "
        "nbase=600, ntrain=800, nquery=4, d=8, n_clusters=6, gt_k=10,\n"
        "    seed=1)\n"
        "cfg = PipelineConfig(\n"
        "    index=IndexParams(d=8, nlist=4, pq_m=2, kmeans_iters=3,\n"
        "                      pq_kmeans_iters=3),\n"
        "    protocol=ProtocolParams(nprobe=2, coarse_probe=20, k=10,\n"
        "                            nquery=3),\n"
        "    nbase=600, train_path=p['train'], base_path=p['base'],\n"
        "    query_path=p['query'], groundtruth_path=p['groundtruth'])\n"
        f"e = QueryEngine(cfg, index_dir={str(tmp_path)!r}, device='cpu')\n"
        "e.init_index()\n"
        "srv = serve_forever(e, '127.0.0.1', 0, background=True)\n"
        "try:\n"
        "    c = ClientPipeline(\n"
        "        cfg, f'http://127.0.0.1:{srv.server_address[1]}/')\n"
        "    q = c.get_query()\n"
        "    _, order = c.sort_nearest_centroids(q, c.get_centroids())\n"
        "    cs, ci, sizes = c.get_coarse_scores(order, q)\n"
        "    assert len(cs) == len(ci) == sizes.sum() and (sizes >= 20).all()\n"
        "    ps, cand = c.get_precise_scores(\n"
        "        c.compute_nearest_coarse_vectors(cs, ci, sizes), q)\n"
        "    want = ((e.base.numpy()[cand] - q[:, None]) ** 2).sum(-1)\n"
        "    assert np.allclose(ps, want, rtol=1e-4, atol=1e-2)\n"
        "finally:\n"
        "    srv.shutdown()\n"
        "    srv.server_close()\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_packed_path_runs_without_jax():
    """The packed response end to end on the CPU with jax, flax, ml_dtypes
    and the JAX package blocked: Galois keys, the threefry-seeded wire, the
    seeded device program (plain K2) and the client's exact decryption.
    Imports made only when a function runs would fail here."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'ml_dtypes', 'prefhetch_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from prefhetch_tpu_torch.client.he import HEClient\n"
        "from prefhetch_tpu_torch.engine.hecompute import HEComputeService\n"
        "from prefhetch_tpu_torch.utils.config import HEParams\n"
        "c = HEClient(HEParams(n=256, resp_mod='packed'), seed=1)\n"
        "s = HEComputeService(c.params, device='cpu')\n"
        "rng = np.random.default_rng(2)\n"
        "base = rng.integers(0, 256, (100, 32)).astype(np.float32)\n"
        "s.set_base(base)\n"
        "s.register_galois_keys('k', c.bfv_extraction_keys_wire(32))\n"
        "q = rng.integers(0, 256, (3, 32)).astype(np.float64)\n"
        "cand = rng.integers(0, 100, (3, 20))\n"
        "cts, norms, g = s.encrypted_scores_packed_wire(\n"
        "    c.encrypt_query_batch(q), cand, 'k')\n"
        "w = [x.to_wire() for x in cts]\n"
        "d = c.decrypt_scores_packed(w, norms, q, g)\n"
        "assert (d == ((base[cand] - q[:, None]) ** 2).sum(-1)).all()\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_ckks_path_runs_without_jax():
    """One combined CKKS request on the CPU with jax, flax, ml_dtypes and
    the JAX package blocked: the client's keys and seedTf wires, the JSON
    route of the port's engine (parked base, the device program on K2's
    plain version) and the client's decryption."""
    code = (
        "import sys, json\n"
        "for m in ('jax', 'jaxlib', 'flax', 'ml_dtypes', 'prefhetch_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from prefhetch_tpu_torch.client.he import HEClient\n"
        "from prefhetch_tpu_torch.engine.server import QueryEngine\n"
        "from prefhetch_tpu_torch.index.build import build_ivf_index\n"
        "from prefhetch_tpu_torch.serve.handlers import Dispatcher\n"
        "from prefhetch_tpu_torch.utils.config import (\n"
        "    HEParams, IndexParams, PipelineConfig)\n"
        "he = HEParams(scheme='ckks', n=256, n_limbs=3, "
        "resp_mod='combined')\n"
        "rng = np.random.default_rng(2)\n"
        "base = rng.integers(0, 256, (300, 32)).astype(np.float32)\n"
        "ip = IndexParams(d=32, nlist=4, pq_m=4, kmeans_iters=2,\n"
        "                 pq_kmeans_iters=2)\n"
        "cfg = PipelineConfig(index=ip, he=he, nbase=300)\n"
        "e = QueryEngine(cfg, device='cpu')\n"
        "e.set_index(build_ivf_index(base, base, ip, device='cpu'), base)\n"
        "c = HEClient(he, seed=1)\n"
        "q = rng.integers(0, 256, (2, 32)).astype(np.float32)\n"
        "cand = rng.integers(0, 300, (2, 20))\n"
        "body = {'scheme': 'ckks', 'keyId': c.key_id, 'respMod': "
        "'combined',\n"
        "        'encryptedPreciseQuery': c.encrypt_query_batch(q),\n"
        "        'nearestCoarseVectorIndexes': cand.tolist(),\n"
        "        'galoisKeys': c.galois_keys_wire(32, "
        "c.combine_blocks(20, 32))}\n"
        "st, _, out = Dispatcher(e).handle('POST', '/encryptedsearch', {},\n"
        "                                  json.dumps(body).encode())\n"
        "assert st == 200, out[:300]\n"
        "r = json.loads(out)\n"
        "d = c.decrypt_scores_combined(r['encryptedScoresCombined'],\n"
        "                              np.asarray(r['candidateNorms']), q)\n"
        "ref = ((base[cand] - q[:, None]) ** 2).sum(-1)\n"
        "assert (np.abs(d - ref) <= 0.08 * ref.max(1, keepdims=True)).all()\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_pir_path_runs_without_jax():
    """One pirHypercube fetch on the CPU with jax, flax, ml_dtypes and the
    JAX package blocked: the client's query and Galois keys
    (client/pir.py, crypto/pir.py), the route of the port's engine
    (engine/pir_device.py on K2's plain version) and the exact row."""
    code = (
        "import sys, json\n"
        "for m in ('jax', 'jaxlib', 'flax', 'ml_dtypes', 'prefhetch_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from prefhetch_tpu_torch.client.pir import get_pir_client\n"
        "from prefhetch_tpu_torch.engine.server import QueryEngine\n"
        "from prefhetch_tpu_torch.index.build import build_ivf_index\n"
        "from prefhetch_tpu_torch.serve.handlers import Dispatcher\n"
        "from prefhetch_tpu_torch.utils.config import (\n"
        "    HEParams, IndexParams, PipelineConfig)\n"
        "he = HEParams(n=256, pir_plain_modulus=257)\n"
        "rng = np.random.default_rng(2)\n"
        "base = rng.integers(0, 256, (300, 32)).astype(np.float32)\n"
        "ip = IndexParams(d=32, nlist=4, pq_m=0, kmeans_iters=2)\n"
        "cfg = PipelineConfig(index=ip, he=he, nbase=300)\n"
        "e = QueryEngine(cfg, device='cpu')\n"
        "e.set_index(build_ivf_index(base, base, ip, device='cpu'), base)\n"
        "c = get_pir_client(cfg, seed=3)\n"
        "w, r = c.build_query_2d(211, 300, 32)\n"
        "body = {'pirHypercube': [w], 'keyId': c.key_id,\n"
        "        'galoisKeys': c.galois_keys_wire_2d(300, 32)}\n"
        "st, _, out = Dispatcher(e).handle('POST', '/pir-fetch', {},\n"
        "                                  json.dumps(body).encode())\n"
        "assert st == 200, out[:300]\n"
        "resp = json.loads(out)['pirResults'][0]\n"
        "assert (c.decode_response_2d(resp, 32, r) == base[211]).all()\n"
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
    files = _port_sources()
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


def test_ntt4_step_wrapper_cpu_takes_plain_version():
    """K2's wrapper: a CPU tensor goes to the plain version (two plain
    stages) and launches nothing; what the kernel would refuse is refused by
    shape and type before any build."""
    from prefhetch_tpu_torch.crypto.params import find_ntt_primes
    from prefhetch_tpu_torch.ops import ntt4_fused as k2
    from prefhetch_tpu_torch.ops import ntt4_step as k2s
    from prefhetch_tpu_torch.ops.ntt4 import build_ntt4_tables, transform_plain

    q = find_ntt_primes(4096, 30, 1)[0]
    tb = build_ntt4_tables(q, 4096)
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, 1 << 31, (2, 4096)).astype(np.int32))
    launches, calls = k2.ntt4_transform.launches, k2s.ntt4_step_plain.calls
    y = k2.ntt4_transform(x, tb, inverse=False)
    assert k2.ntt4_transform.launches == launches
    assert k2s.ntt4_step_plain.calls == calls + 2
    assert y.dtype == torch.int32 and y.shape == x.shape
    assert int(y.min()) >= 0 and int(y.max()) < q
    assert torch.equal(y, transform_plain(x, tb, False))
    # negative int32 values are taken as their residue
    np.testing.assert_array_equal(
        k2.ntt4_transform(x - q, tb, inverse=False).numpy(), y.numpy())
    # int64 input is taken by its low 32 bits, as .to(torch.int32) does
    np.testing.assert_array_equal(
        k2.ntt4_transform(x.long(), tb, inverse=True).numpy(),
        transform_plain(x, tb, True).numpy())
    assert k2.check(x, tb) == 2 and k2.check(x.long(), tb) == 2
    with pytest.raises(ValueError, match="int32 or int64"):
        k2.check(x.short(), tb)
    with pytest.raises(ValueError, match="contiguous"):
        k2.check(x.reshape(2, 64, 64).transpose(1, 2).reshape(2, 4096)
                 .T.contiguous().T, tb)
    with pytest.raises(ValueError, match="contiguous"):
        k2.check(x.reshape(4, 2048), tb)
    with pytest.raises(ValueError, match="non-empty"):
        k2.check(x[:0], tb)
    q256 = find_ntt_primes(256, 30, 1)[0]
    small = build_ntt4_tables(q256, 256)          # 16 x 16: no served ring
    with pytest.raises(ValueError, match="64 x n2"):
        k2.check(torch.zeros((1, 256), dtype=torch.int32), small)
    with pytest.raises(ValueError, match="cuda or cpu"):
        k2.ntt4_transform(x.to("meta"), tb, inverse=False)
    # the Shoup companions: floor(tw * 2^32 / q), exact in Python integers
    tws = tb.f_a.tw_shoup
    assert tws.dtype == np.uint32 and tb.f_b.tw_shoup is None
    for i, j in ((0, 0), (5, 9), (63, 63)):
        assert int(tws[i, j]) == (int(tb.f_a.tw[i, j]) << 32) // q


def test_he_service_follows_the_engine_device(monkeypatch):
    """No backend switch: the service sits on the engine's device, and the
    default device refuses to start without CUDA."""
    from prefhetch_tpu_torch.crypto.params import bfv_params_for
    from prefhetch_tpu_torch.engine.hecompute import HEComputeService

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("PFH_HE_BACKEND", "numpy")
    p = bfv_params_for(256, 24, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HEComputeService(p)
    svc = HEComputeService(p, device="cpu")
    assert svc.device == torch.device("cpu")
    assert svc._perm.device == torch.device("cpu")


@pytest.mark.parametrize("kernel,variant", [
    (k, v) for k, (_, variants) in sorted(ka.SOURCES.items())
    for v in variants])
def test_ablation_edits_match_the_current_sources(kernel, variant):
    """Every edit of tools/kernel_ablation.py (what ``chip_smoke.py``
    compiles for its ablation phase) matches its kernel's source exactly
    once, so a change to a patched line fails here and not first on the
    card."""
    name, variants = ka.SOURCES[kernel]
    src = (cuda_build.CSRC / f"{name}.cu").read_text()
    edited = ka.apply_edits(src, variants[variant], f"{kernel}/{variant}")
    assert edited != src
    with pytest.raises(ValueError, match="does not match"):
        ka.apply_edits(edited, variants[variant], "twice")


def test_substituted_library_is_restored():
    """cuda_build.substituted: inside the block load() returns the given
    library, after it the state before (here: nothing loaded)."""
    some_lib = pathlib.Path(torch.__file__).parent / "lib" / "libc10.so"
    assert "probe" not in cuda_build._loaded
    with cuda_build.substituted("probe", some_lib) as lib:
        assert cuda_build.load("probe") is lib
    assert "probe" not in cuda_build._loaded
