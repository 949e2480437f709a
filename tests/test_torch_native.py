"""The port's host C++ libraries (prefhetch_tpu_torch/native): the JSON
number-array codec writes the JAX package's bytes, decodes them back, and
the build is safe when processes race for it and loud when it fails.

The JAX codec is built here from its own source (native/prefhetch_native.cpp)
with the JAX loader's flags, into a test directory, and bound into the JAX
loader in place of the library it would build in native/build/: the JAX
wrappers run unchanged, and the test never races other test files for
that shared build."""

import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from prefhetch_tpu import native as j_native
from prefhetch_tpu_torch import native as t_native

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_codec(tmp_path_factory):
    out = tmp_path_factory.mktemp("jcodec") / "libjax_codec.so"
    subprocess.run(
        ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
         "-pthread", str(ROOT / "native" / "prefhetch_native.cpp"), "-o",
         str(out)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    i64, vp = ctypes.c_int64, ctypes.c_void_p
    for fn in (lib.pfh_json_encode_f32, lib.pfh_json_encode_i64):
        fn.argtypes = [vp, i64, ctypes.c_char_p, i64]
        fn.restype = i64
    lib.pfh_json_decode_f64.argtypes = [ctypes.c_char_p, i64, vp, i64]
    lib.pfh_json_decode_f64.restype = i64
    return lib


@pytest.fixture
def jx(jax_codec, monkeypatch):
    monkeypatch.setattr(j_native, "_lib", jax_codec)
    return j_native


def _floats(rng, n):
    """f32 values across the formatter's branches: plain decimals, tiny and
    huge magnitudes (snprintf), integers, negatives, zero and round-up."""
    parts = [
        rng.normal(size=n) * 1e3,
        rng.uniform(0, 1, n) * 1e-6,
        rng.uniform(1e17, 1e30, n),
        rng.integers(-2**24, 2**24, n).astype(np.float64),
        -rng.exponential(5e6, n),
        np.array([0.0, -0.0, 0.99999999, 9.9999999e-5, 1e-4, 123456789.0,
                  3.4e38, 0.5, 65535.0]),
    ]
    return np.concatenate(parts).astype(np.float32)


@pytest.mark.parametrize("n", [0, 1, 7, 5000])
def test_codec_same_bytes_as_jax(jx, n):
    rng = np.random.default_rng(n)
    x = _floats(rng, n)
    i = np.concatenate([rng.integers(-2**62, 2**62, n),
                        [0, -1, 2**63 - 1, -2**63]]).astype(np.int64)
    for a in (x, x[:n], np.empty(0, np.float32)):
        assert t_native.json_encode_f32(a) == jx.json_encode_f32(a)
    for a in (i, i[:n], np.empty(0, np.int64)):
        assert t_native.json_encode_i64(a) == jx.json_encode_i64(a)
    for shape in ((2, 3, -1), (1, -1), (-1, 1), (2, 1, 3, -1)):
        n_el = -np.prod(shape)
        nested = x[: n_el * (len(x) // n_el)].reshape(shape)
        if nested.size:
            assert t_native.json_encode_f32_nested(nested) == \
                jx.json_encode_f32_nested(nested), shape
    empty_rows = np.empty((3, 0), np.float32)
    assert t_native.json_encode_f32_nested(empty_rows) == \
        jx.json_encode_f32_nested(empty_rows) == b"[[],[],[]]"
    big = rng.uniform(0, 255, (64, 10, 128)).astype(np.float32)
    assert t_native.json_encode_f32_nested(big) == \
        jx.json_encode_f32_nested(big)


def test_codec_round_trips_and_decodes_jax_bodies(jx):
    rng = np.random.default_rng(1)
    x = _floats(rng, 3000)
    ids = rng.integers(0, 10**9, 3000).astype(np.int64)
    body = (b'{"coarseDistanceScores":' + jx.json_encode_f32(x)
            + b',"coarseVectorIndexes":' + jx.json_encode_i64(ids) + b"}")
    got = t_native.json_decode_field(body, "coarseDistanceScores")
    np.testing.assert_array_equal(got.astype(np.float32), x)
    np.testing.assert_array_equal(
        t_native.json_decode_field(body, "coarseVectorIndexes"), ids)
    # json.dumps spacing and a missing key: the client parses with json
    spaced = json.dumps({"a": [1.5, 2.5]}).encode()
    np.testing.assert_array_equal(t_native.json_decode_field(spaced, "a"),
                                  [1.5, 2.5])
    assert t_native.json_decode_field(spaced, "b") is None
    assert t_native.json_decode_array(b"[1 2]") is None
    assert t_native.json_decode_array(b"[1,,2]") is None
    np.testing.assert_array_equal(t_native.json_decode_array(b"[]"), [])


_BUILD = """
import sys
from pathlib import Path
from prefhetch_tpu_torch import native
path = native.build(native.CODEC, Path(sys.argv[1]))
import ctypes, numpy as np
lib = ctypes.CDLL(str(path))
native._bind_codec(lib)
x = np.arange(5, dtype=np.float32) / 4
buf = ctypes.create_string_buffer(256)
n = lib.pfh_json_encode_f32(x.ctypes.data_as(ctypes.c_void_p), 5, buf, 256)
print(buf.raw[:n].decode())
"""


def test_two_processes_build_at_once_and_both_load(tmp_path):
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        finally:
            p.kill()
        assert p.returncode == 0, err
        outs.append(out.strip())
    assert outs == ["[0,0.25,0.5,0.75,1]"] * 2
    built = sorted(f.name for f in tmp_path.iterdir())
    assert built == [f"{t_native.CODEC}.lock",
                     t_native.library_path(t_native.CODEC, tmp_path).name]


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(t_native, "SRC", tmp_path)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build broken"
                       ) as e:
        t_native.build("broken", tmp_path / "build")
    assert "error" in str(e.value)
    assert not any((tmp_path / "build").glob("*.so*"))
