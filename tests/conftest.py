"""Shared test configuration.

Tests run on the CPU backend, on a virtual 8-device CPU mesh so the
multi-device sharding tests run without accelerators (the standard JAX
trick; SURVEY.md §4).  Must run before jax is imported anywhere.  Tests
that need an NVIDIA GPU carry the ``gpu`` marker and take the ``gpu_card``
fixture, which decides at run time whether a card is present.
"""

import os
import pathlib
import shutil
import subprocess

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest

# ---------------------------------------------------------------------------
# Quick tier: `pytest -m quick` for the edit-test loop — the full suite
# stays the merge gate (CI runs it).  Membership: the format-critical fast
# modules.
# ---------------------------------------------------------------------------

QUICK_MODULES = {"test_spec", "test_ops_ac", "test_host", "test_cli",
                 "test_codec_jax"}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "quick: fast tier for the edit-test loop"
    )


# XLA:CPU's JIT has a bounded LLVM section-memory arena per process
# (CLAUDE.md): after a few hundred distinct compiles, the NEXT big compile
# segfaults regardless of free RAM.  Dropping the jit caches releases the
# arena; do it every N tests.
_CLEAR_EVERY = 25
_test_counter = [0]


def pytest_runtest_teardown(item, nextitem):
    _test_counter[0] += 1
    if _test_counter[0] % _CLEAR_EVERY == 0:
        import jax

        jax.clear_caches()


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.module.__name__ in QUICK_MODULES:
            item.add_marker(pytest.mark.quick)


ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden"
# C source text that every checkout holds (the native host codec)
C_TEXT = ROOT / "native" / "x3host.cpp"
# Sources of the reference C binary (xbarin02/x3-compressor: *.c, *.h and
# its Makefile), never vendored here; cross-tests skip when unset.
REFERENCE_SRC = os.environ.get("X3_REFERENCE_SRC", "")

# Golden fixture parameter sets: name -> CLI args of the reference binary.
PARAMSETS = {
    "t15_w8": dict(max_match_count=15, window=8 * 1024),
    "t4_w1": dict(max_match_count=4, window=1024),
    "t2_w1_x": dict(max_match_count=2, window=1024, nl_remap=True),
    "t8_w2_m0": dict(max_match_count=8, window=2 * 1024, magic_factor1=0),
}


def golden_cases():
    """(input_name, paramset_name) pairs for which a golden .x3 exists."""
    cases = []
    for x3 in sorted(GOLDEN.glob("*.x3")):
        name, pname = x3.name[: -len(".x3")].rsplit(".", 1)
        cases.append((name, pname))
    return cases


@pytest.fixture(scope="session")
def ref_binary(tmp_path_factory):
    """Build the reference binary from ``$X3_REFERENCE_SRC`` at test time
    (never vendored into the repo); skip reference cross-tests when the
    sources or the toolchain are missing."""
    src = pathlib.Path(REFERENCE_SRC) if REFERENCE_SRC else None
    if src is None or not (src / "Makefile").is_file():
        pytest.skip("reference sources not given (set X3_REFERENCE_SRC)")
    builddir = tmp_path_factory.mktemp("x3ref")
    for f in src.glob("*.[ch]"):
        (builddir / f.name).write_bytes(f.read_bytes())
    (builddir / "Makefile").write_bytes((src / "Makefile").read_bytes())
    try:
        subprocess.run(
            ["make", "BUILD=release", "-j4"],
            cwd=builddir,
            check=True,
            capture_output=True,
        )
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        pytest.skip(f"cannot build reference binary: {e}")
    return builddir / "x3"


@pytest.fixture
def gpu_card():
    """The first NVIDIA GPU's nvidia-smi line; skips without one.  Asked
    of nvidia-smi in a child process, never of this (CPU-pinned) JAX, and
    only when a test runs — never at import or collection."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        pytest.skip("no NVIDIA GPU: nvidia-smi not found")
    r = subprocess.run([smi, "-L"], capture_output=True, text=True,
                       timeout=60)
    if r.returncode != 0 or "GPU" not in r.stdout:
        pytest.skip("no NVIDIA GPU: nvidia-smi lists none")
    return r.stdout.splitlines()[0]
