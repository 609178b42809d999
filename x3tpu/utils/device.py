"""Where a run executes: the compile-cache location and the device label
every printed measurement carries.

Both entry points that report numbers (``bench.py``, ``chip_smoke.py``)
and the CLI share these helpers, so a result always names its device and
every process finds the same persistent compile cache.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
from typing import Dict

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
# fixed, inside the checkout and listed in .gitignore: the cache is keyed
# by program, but only a directory that never moves is found again
REPO_CACHE = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"

SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its one directory and
    return it.  When ``JAX_COMPILATION_CACHE_DIR`` is set JAX reads it
    itself and nothing is changed here; otherwise the cache lives in
    ``<checkout>/.jax_cache``."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE))
    return str(REPO_CACHE)


def nvidia_smi() -> str:
    """The cards' names and power limits, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit`` prints them.  Runs in a
    child process that never touches JAX, so it holds no device memory."""
    try:
        out = subprocess.run(SMI_QUERY, capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out or "nvidia-smi listed no card"


def describe() -> Dict[str, object]:
    """The label of a measurement: platform, device kind and count as JAX
    reports them, plus the first card's name and power limit."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
        "card": nvidia_smi().splitlines()[0],
    }
