"""The port's native host library (prefhetch_tpu_torch/native/host_lib.cpp):
the Shoup NTT under every host transform (crypto/ntt.py) and the vecs
reader (data/io.py).

The NTT is held to the numpy butterfly (the oracle kept in crypto/ntt.py)
on canonical, negative and ≥ q inputs at every prime the port's parameter
sets use, and to the JAX package's own native transform on canonical
inputs. The JAX library is built here from its source
(native/prefhetch_native.cpp) with the JAX loader's flags into a test
directory and bound into the JAX loader, as tests/test_torch_native.py
does for the codec; its wrappers run unchanged."""

import ctypes
import pathlib
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest

from prefhetch_tpu import native as j_native
from prefhetch_tpu.crypto import ntt as j_ntt
from prefhetch_tpu.data import io as j_io
from prefhetch_tpu_torch import native as t_native
from prefhetch_tpu_torch.crypto import ntt as t_ntt
from prefhetch_tpu_torch.crypto.bfv import BFVContext
from prefhetch_tpu_torch.crypto.params import (
    bfv_params_for, find_ntt_primes, pir_params_for,
)
from prefhetch_tpu_torch.data import io as t_io

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _primes():
    """Every prime of the HEParams defaults (BFV N=4096, 2 limbs, with the
    packed key switch's special prime), config 3 (CKKS N=8192, 3 limbs,
    with its special prime) and PIR (N=4096, t=257)."""
    out = []
    for p in (bfv_params_for(4096, 24, 2), pir_params_for(4096, 257, 2)):
        out += list(p.qs) + [BFVContext(p)._special_p]
    out += find_ntt_primes(8192, 30, 4)     # config 3's 3 limbs + special
    return sorted(set(out))


PRIMES = _primes()


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("jnative") / "libjax_native.so"
    subprocess.run(
        ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
         "-pthread", str(ROOT / "native" / "prefhetch_native.cpp"), "-o",
         str(out)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    i64, vp = ctypes.c_int64, ctypes.c_void_p
    lib.pfh_vecs_header.argtypes = [ctypes.c_char_p, ctypes.POINTER(i64),
                                    ctypes.POINTER(i64)]
    lib.pfh_vecs_header.restype = ctypes.c_int
    lib.pfh_vecs_read.argtypes = [ctypes.c_char_p, vp, i64, i64]
    lib.pfh_vecs_read.restype = ctypes.c_int
    lib.pfh_ntt_batch.argtypes = [vp, i64, i64, i64, vp, vp, vp, vp, vp,
                                  ctypes.c_int, ctypes.c_int]
    lib.pfh_ntt_batch.restype = None
    return lib


@pytest.fixture
def jx(jax_lib, monkeypatch):
    monkeypatch.setattr(j_native, "_lib", jax_lib)
    monkeypatch.setattr(j_native, "_tried", True)
    return j_native


def _inputs(rng, q, shape):
    """Canonical, negative (down to -4q and to -2^32) and ≥ q (up to 8q
    and 2^32) values: within ±2^32 the butterfly's int64 products do not
    overflow, so it gives the residue's transform."""
    return {
        "canonical": rng.integers(0, q, shape),
        "negative": rng.integers(-4 * q, 0, shape),
        "geq q": rng.integers(q, 8 * q, shape),
        "wide": rng.integers(-(1 << 32) + 1, 1 << 32, shape),
    }


@pytest.mark.parametrize("n", [256, 4096])
@pytest.mark.parametrize("q", PRIMES)
def test_native_ntt_matches_butterfly(q, n):
    tb = t_ntt.build_tables(q, n)
    rng = np.random.default_rng(q % 1000 + n)
    for kind, x in _inputs(rng, q, (3, n)).items():
        for fn, plain in ((t_ntt.ntt, t_ntt.ntt_plain),
                          (t_ntt.intt, t_ntt.intt_plain)):
            got = fn(x, tb)
            assert got.dtype == np.int64 and got.shape == x.shape
            np.testing.assert_array_equal(got, plain(x, tb),
                                          err_msg=f"{fn.__name__} {kind}")


@pytest.mark.parametrize("n", [256, 4096])
def test_native_ntt_matches_jax_native_on_canonical_inputs(jx, n):
    """The port's transform against the JAX package's NativeNTT (its C++
    library) and its jnp butterfly, both directions; the JAX test's round
    trip (tests/test_native.py)."""
    for q in PRIMES[:3]:
        tb = t_ntt.build_tables(q, n)
        x = np.random.default_rng(q % 97).integers(0, q, (8, n))
        fwd = t_ntt.ntt(x, tb)
        np.testing.assert_array_equal(
            fwd, jx.NativeNTT(q, n, inverse=False)(x))
        jtb = j_ntt.build_tables(q, n)
        np.testing.assert_array_equal(
            fwd, np.asarray(j_ntt.ntt(jnp.asarray(x), jtb)))
        inv = t_ntt.intt(fwd, tb)
        np.testing.assert_array_equal(inv, x)
        np.testing.assert_array_equal(
            t_ntt.intt(x, tb), jx.NativeNTT(q, n, inverse=True)(x))


def test_native_ntt_exact_over_all_int64(jx):
    """Where the butterfly's products overflow (|x| ≥ 2^32) the native
    transform stays the residue's: the round trip gives x mod q. The JAX
    library reads a negative int64 as x + 2^64 (ROADMAP "Known
    differences"): on negative inputs it differs from the port."""
    n = 256
    q = PRIMES[0]
    tb = t_ntt.build_tables(q, n)
    x = np.random.default_rng(1).integers(-(1 << 63), (1 << 63) - 1, (4, n))
    x[0, :4] = [-(1 << 63), (1 << 63) - 1, -1, q]
    np.testing.assert_array_equal(t_ntt.intt(t_ntt.ntt(x, tb), tb), x % q)
    np.testing.assert_array_equal(t_ntt.ntt(t_ntt.intt(x, tb), tb), x % q)
    neg = -np.random.default_rng(2).integers(1, q, (2, n))
    assert not np.array_equal(jx.NativeNTT(q, n)(neg), t_ntt.ntt(neg, tb))
    np.testing.assert_array_equal(t_ntt.ntt(neg, tb),
                                  t_ntt.ntt_plain(neg, tb))


def test_native_ntt_shapes_and_input_untouched():
    n, q = 256, PRIMES[0]
    tb = t_ntt.build_tables(q, n)
    rng = np.random.default_rng(3)
    for shape in ((n,), (2, 3, n), (0, n)):
        x = rng.integers(-q, 2 * q, shape).astype(np.int32)
        keep = x.copy()
        got = t_ntt.ntt(x, tb)
        np.testing.assert_array_equal(x, keep)
        assert got.shape == shape and got.dtype == np.int64
        np.testing.assert_array_equal(got, t_ntt.ntt_plain(x, tb))
        np.testing.assert_array_equal(t_ntt.intt(got, tb), x % q)
    with pytest.raises(ValueError, match="length 256"):
        t_ntt.ntt(np.zeros((2, 128), np.int64), tb)


def test_native_ntt_from_eight_threads_at_once(monkeypatch):
    """8 threads fill the transform cache and transform at once (served
    paths call host transforms from resolver threads and the batcher
    together); each result equals the butterfly's."""
    monkeypatch.setattr(t_ntt, "_native_ntts", {})
    jobs = [(q, n, inv) for q in PRIMES[:2] for n in (256, 1024)
            for inv in (False, True)]
    assert len(jobs) == 8
    errors, done = [], []
    start = threading.Barrier(len(jobs))

    def work(q, n, inv):
        try:
            tb = t_ntt.build_tables(q, n)
            x = np.random.default_rng(n + inv).integers(-q, 2 * q, (16, n))
            start.wait(timeout=60)
            for _ in range(10):
                got = (t_ntt.intt if inv else t_ntt.ntt)(x, tb)
                want = (t_ntt.intt_plain if inv else t_ntt.ntt_plain)(x, tb)
                if not np.array_equal(got, want):
                    errors.append((q, n, inv))
            done.append((q, n, inv))
        except Exception as e:        # reported by the main thread
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=j) for j in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and len(done) == len(jobs)
    assert sorted(t_ntt._native_ntts) == sorted(jobs)


def test_shoup_constants_and_pointwise_mulmod():
    rng = np.random.default_rng(4)
    for q in PRIMES:
        w = np.concatenate([rng.integers(0, q, 500), [0, 1, q - 1]])
        want = np.array([(int(v) << 64) // q for v in w], np.uint64)
        np.testing.assert_array_equal(
            t_native.shoup(w, q).view(np.uint64), want)
        a = rng.integers(-(1 << 62), 1 << 62, 700)
        b = rng.integers(0, 3 * q, 700)
        want = np.array([int(x) * int(y) % q for x, y in zip(a, b)],
                        np.int64)
        np.testing.assert_array_equal(t_native.pointwise_mulmod(a, b, q),
                                      want)
    with pytest.raises(ValueError, match="q < 2\\^31"):
        t_native.shoup(np.zeros(2, np.int64), 1 << 31)


def test_negacyclic_polymul_matches_jax_and_schoolbook():
    """tests/test_crypto_bfv.py's check of the JAX negacyclic_polymul."""
    n, q = 256, PRIMES[0]
    rng = np.random.default_rng(5)
    a = rng.integers(0, q, n)
    b = rng.integers(0, q, n)
    got = t_ntt.negacyclic_polymul(a, b, t_ntt.build_tables(q, n))
    np.testing.assert_array_equal(got, t_ntt.naive_negacyclic_polymul(a, b, q))
    np.testing.assert_array_equal(got, np.asarray(j_ntt.negacyclic_polymul(
        jnp.asarray(a), jnp.asarray(b), j_ntt.build_tables(q, n))))


def test_failed_host_build_raises_on_transform(tmp_path, monkeypatch):
    """No numpy fallback: a host library that does not build makes every
    transform raise with g++'s output."""
    (tmp_path / f"{t_native.HOST}.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(t_native, "SRC", tmp_path)
    monkeypatch.setattr(t_native, "_libs", {})
    monkeypatch.setattr(t_ntt, "_native_ntts", {})
    tb = t_ntt.build_tables(PRIMES[0], 256)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build host"):
        t_ntt.ntt(np.zeros(256, np.int64), tb)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build host"):
        t_native.read_vecs_native(str(tmp_path / "x.fvecs"), np.float32)


# -- vecs ---------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["fvecs", "ivecs"])
def test_native_read_vecs_matches_numpy_and_jax(jx, tmp_path, kind):
    """tests/test_native.py's fvecs and ivecs reads: bit-equal to the
    array written, to the port's reader and to the JAX native reader."""
    rng = np.random.default_rng(6)
    if kind == "fvecs":
        arr = rng.normal(size=(50, 17)).astype(np.float32)
        write, read, dt = t_io.write_fvecs, t_io.read_fvecs, np.float32
    else:
        arr = rng.integers(0, 100000, size=(20, 100)).astype(np.int32)
        write, read, dt = t_io.write_ivecs, t_io.read_ivecs, np.int32
    p = str(tmp_path / f"x.{kind}")
    write(p, arr)
    got = t_native.read_vecs_native(p, dt)
    assert got.dtype == dt
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(read(p), arr)
    np.testing.assert_array_equal(jx.read_vecs_native(p, dt), arr)
    d, n, flat = t_io.vecs_read(p)
    assert (d, n) == arr.shape[::-1]
    np.testing.assert_array_equal(flat, arr.reshape(-1))


def test_native_read_errors(jx, tmp_path):
    """tests/test_native.py's corrupt header, and the reader's messages:
    the up-front checks keep the reference's, a native error code is named
    in a ValueError."""
    bad = tmp_path / "bad.fvecs"
    bad.write_bytes(b"\xff\xff\xff\xff" + b"\x00" * 4)
    with pytest.raises(ValueError, match="native header error -3"):
        t_native.read_vecs_native(str(bad), np.float32)
    with pytest.raises(ValueError, match="incorrect dimensions d=-1"):
        t_io.read_fvecs(str(bad))
    rows = np.zeros((3, 5), "<i4")
    rows[:, 0] = 4
    rows[2, 0] = 3                               # one row's header differs
    mixed = tmp_path / "mixed.ivecs"
    rows.tofile(mixed)
    for read in (t_io.read_ivecs, j_io.read_ivecs):
        with pytest.raises(ValueError):
            read(str(mixed))
    with pytest.raises(ValueError, match="native read error -5"):
        t_io.read_ivecs(str(mixed))
    short = tmp_path / "short.fvecs"
    short.write_bytes(np.array([4, 0, 0], "<i4").tobytes())
    with pytest.raises(ValueError, match="incorrect file size 12 for d=4"):
        t_io.read_fvecs(str(short))
    empty = tmp_path / "empty.fvecs"
    empty.write_bytes(b"")
    with pytest.raises(ValueError, match="empty vecs file"):
        t_io.read_fvecs(str(empty))
    with pytest.raises(FileNotFoundError):
        t_io.read_fvecs(str(tmp_path / "missing.fvecs"))


def test_smoke_lift_ablation_builds_and_matches(tmp_path):
    """chip_smoke.py [native] times the host library with its lift of
    negative inputs taken out: the edit must still match the source, and
    that library must give the same transform on canonical input (and the
    JAX library's answer on a negative one)."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    lib = chip_smoke.build_host_lib_without_lift(str(tmp_path))
    n, q = 256, PRIMES[0]
    tb = t_ntt.build_tables(q, n)
    fn = t_ntt._native(tb, False)
    for x, want in ((np.random.default_rng(8).integers(0, q, (3, n)), None),
                    (-np.arange(1, n + 1)[None], "differs")):
        out = np.array(x, np.int64)
        lib.pfh_ntt_batch(t_native._ptr(out), out.shape[0], n, q,
                          t_native._ptr(fn.psi), t_native._ptr(fn.psi_sh),
                          t_native._ptr(fn.tw), t_native._ptr(fn.tw_sh),
                          t_native._ptr(fn.bitrev), 1, 1)
        assert np.array_equal(out, t_ntt.ntt(x, tb)) == (want is None)
