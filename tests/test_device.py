"""Device plumbing: the compile-cache rule, device labels, the bench's
refusal to run without a GPU, exact f32 probabilities, and a runtime that
imports no Pallas kernel library."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from x3tpu.models.adaptive import f32_prob
from x3tpu.utils import device

from conftest import ROOT


@pytest.fixture
def cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_follows_env(monkeypatch, cache_config):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the
    helper changes nothing."""
    monkeypatch.setenv(device.CACHE_ENV, "/elsewhere/cache")
    before = jax.config.jax_compilation_cache_dir
    assert device.enable_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_checkout(monkeypatch, cache_config):
    monkeypatch.delenv(device.CACHE_ENV, raising=False)
    got = device.enable_compile_cache()
    assert got == str(ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    # fixed: the same path on every call, listed in .gitignore
    assert device.enable_compile_cache() == got
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_describe_names_the_device():
    label = device.describe()
    assert label["platform"] == "cpu"
    assert label["device_count"] == len(jax.devices())
    assert label["device_kind"] == jax.devices()[0].device_kind
    assert isinstance(label["card"], str) and label["card"]


def _bench(args, **env):
    e = {k: v for k, v in dict(os.environ, **env).items() if v is not None}
    return subprocess.run([sys.executable, "bench.py", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=900, env=e)


def test_bench_refuses_without_gpu():
    """No GPU and no explicit CPU request: non-zero exit, no row."""
    r = _bench(["1", "1"], JAX_PLATFORMS=None, CUDA_VISIBLE_DEVICES="")
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert r.stdout.strip() == ""


def test_bench_cpu_rows_name_cpu():
    """JAX_PLATFORMS=cpu asked explicitly: every row says cpu."""
    r = _bench(["1", "1"], JAX_PLATFORMS="cpu")
    assert r.returncode == 0, r.stderr[-3000:]
    rows = [json.loads(x) for x in r.stdout.strip().splitlines()]
    assert [row["metric"] for row in rows] == [
        "encode_throughput_default_params",
        "decode_throughput_default_params"]
    for row in rows:
        assert row["platform"] == "cpu" and row["device_count"] >= 1
        assert row["device_kind"] and row["card"]
        assert len(row["runs_s"]) == 3 and row["value"] > 0


def test_runtime_imports_no_pallas():
    code = ("import sys, x3tpu.parallel.runtime, x3tpu.cli, x3tpu.host; "
            "bad = [m for m in sys.modules if 'pallas' in m or "
            "m.startswith('x3tpu.vm')]; print(bad); "
            "raise SystemExit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stdout + r.stderr


def _operands(kind, n=20000):
    rng = np.random.default_rng({"small": 1, "wide": 2, "near_one": 3,
                                 "midpoints": 4}[kind])
    if kind == "small":
        a, b = rng.integers(0, 5000, n), rng.integers(1, 5000, n)
    elif kind == "wide":  # past 2^24: the int -> f32 conversion rounds
        a, b = rng.integers(0, 2**31 - 1, n), rng.integers(1, 2**31 - 1, n)
    elif kind == "near_one":
        b = rng.integers(1, 1 << 26, n)
        a = np.maximum(b + rng.integers(-3, 4, n), 0)
    else:  # odd 24-bit numerators over small powers of two: exact ties
        a = (rng.integers(1 << 22, 1 << 23, n) * 2 + 1)
        b = 2 ** rng.integers(1, 5, n)
    return a.astype(np.int32), b.astype(np.int32)


@pytest.mark.parametrize("kind", ["small", "wide", "near_one", "midpoints"])
def test_f32_prob_is_correctly_rounded(kind):
    """The mode-selection probabilities must equal C's (float)a / b bit for
    bit (IEEE round-to-nearest-even), whatever the backend's divider."""
    a, b = _operands(kind)
    want = np.float32(a.astype(np.float32) / b.astype(np.float32))
    got = np.asarray(jax.jit(f32_prob)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
