"""Benchmark harness: lane-parallel encode and decode throughput on a GPU.

Usage: python bench.py [lanes] [block_kib]        (default 32 lanes x 16 KiB)

Prints one JSON line per row, each labelled with the device it ran on
(platform, device kind, device count, and the card's name and power
limit as nvidia-smi reports them):
  {"metric": ..., "value": N, "unit": "MB/s", "vs_baseline": N, ...}

The input is ``build_corpus(lanes * block)`` at the reference defaults
(-t 15 -w 8).  Each direction compiles and warms up once (set-up), then
runs three times; the median is reported, with every run's seconds.  A
timed run ends in ``jax.block_until_ready`` and a host readback.  Encode
streams are round-trip-checked through the native host decoder and the
decode output against the input.

Baseline: the reference C binary's own codec-loop time on one x86 core at
the same parameters (BENCH_NOTES.md "Matched-corpus baseline"): 0.0508
MB/s encode, 0.0915 MB/s decode.  It was measured on an earlier text
corpus (the reference's C sources followed by JAX's), so ``vs_baseline``
compares against a text corpus of the same class, not the same bytes.

A run that finds no GPU exits non-zero, unless ``JAX_PLATFORMS=cpu`` was
asked for explicitly; then every row says ``cpu``.  Extra lane-count rows:
``X3TPU_BENCH_SCALING=64,128``.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np

BASELINE_ENCODE_MBS = 0.0508
BASELINE_DECODE_MBS = 0.0915  # reference binary (BENCH_NOTES)

ROOT = Path(__file__).resolve().parent


def log(msg: str) -> None:
    print(f"[bench +{time.time() - T0:6.1f}s] {msg}", file=sys.stderr, flush=True)


T0 = time.time()


def build_corpus(total: int) -> bytes:
    """Deterministic diverse source-text corpus: the checkout's C and text
    test fixtures, then the installed JAX package's Python sources in path
    order (tens of MB of distinct text, so multi-MB corpora don't
    degenerate into repeats of one blob).  Both exist wherever the program
    runs, and the JAX version pins the bytes."""
    import jax

    golden = ROOT / "tests" / "golden"
    parts = [(golden / name).read_bytes()
             for name in ("c_source.bin", "text_small.bin")]
    budget = total + (1 << 20)
    acc = sum(len(p) for p in parts)
    for f in sorted(Path(os.path.dirname(jax.__file__)).rglob("*.py")):
        if acc >= budget:
            break
        b = f.read_bytes()
        parts.append(b)
        acc += len(b)
    blob = b"".join(parts)
    reps = total // len(blob) + 1
    return (blob * reps)[:total]


def _median_run(fn, n: int = 3):
    """(last result, median seconds, every run's seconds)."""
    import jax

    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return out, statistics.median(times), times


def main() -> int:
    lanes = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    block_kib = int(sys.argv[2]) if len(sys.argv) > 2 else 16

    import jax

    from x3tpu.utils import device

    device.enable_compile_cache()
    label = device.describe()
    if label["platform"] != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        log(f"FATAL: no GPU found (JAX runs on {label['platform']!r}); "
            f"set JAX_PLATFORMS=cpu to measure the CPU backend explicitly")
        return 2

    import jax.numpy as jnp

    from x3tpu import codec, host
    from x3tpu.config import X3Params
    from x3tpu.parallel.runtime import caps_for_block

    block = block_kib * 1024
    params = X3Params()  # reference defaults: -t 15 -w 8
    caps = caps_for_block(block)

    def row(metric: str, mbs: float, baseline: float, runs) -> None:
        print(json.dumps({
            "metric": metric, "value": round(mbs, 4), "unit": "MB/s",
            "vs_baseline": round(mbs / baseline, 2),
            "runs_s": [round(t, 3) for t in runs], **label,
        }), flush=True)

    def measure(n: int, suffix: str) -> None:
        data = build_corpus(n * block)
        blocks = [data[i * block:(i + 1) * block] for i in range(n)]
        log(f"corpus ready: {n} lanes x {block_kib} KiB on "
            f"{label['device_kind']}")
        text, tlen = codec.pack_blocks(blocks, params, caps)
        text_j, tlen_j = jnp.asarray(text), jnp.asarray(tlen)

        def enc():
            return codec.encode_blocks_chunked(text_j, tlen_j, params, caps)

        jax.block_until_ready(enc())  # compile + warm up (set-up)
        log("encode compile + warmup done")
        (words, byte_lens, _, _, overflow), dt, runs = _median_run(enc)
        codec._check_overflow(overflow)  # names the lane and capacity
        words_np, lens_np = np.asarray(words), np.asarray(byte_lens)
        for i, b in enumerate(blocks):
            stream = words_np[i].astype("<u4").tobytes()[: lens_np[i]]
            if host.decode(stream, max_output=len(b) + 64) != b:
                raise RuntimeError(f"round-trip fail lane {i}")
        log(f"timed encode: {dt:.3f}s median of {runs}; round trip ok")
        row(f"encode_throughput{suffix}", len(data) / dt / 1e6,
            BASELINE_ENCODE_MBS, runs)

        iw = (int(lens_np.max()) + 3) // 4 + 2
        words_in = jnp.asarray(words_np[:, :iw].astype(np.uint32))
        lens_in = jnp.asarray(lens_np)

        def dec():
            return codec.decode_blocks_chunked(words_in, lens_in, params,
                                               caps)

        jax.block_until_ready(dec())
        log("decode compile + warmup done")
        (out, opos, *_), ddt, druns = _median_run(dec)
        out_np, opos_np = np.asarray(out), np.asarray(opos)
        for i, b in enumerate(blocks):
            if out_np[i, : opos_np[i]].tobytes() != b:
                raise RuntimeError(f"decode fail lane {i}")
        log(f"timed decode: {ddt:.3f}s median of {druns}")
        row(f"decode_throughput{suffix}", len(data) / ddt / 1e6,
            BASELINE_DECODE_MBS, druns)

    measure(lanes, "_default_params")
    scaling = os.environ.get("X3TPU_BENCH_SCALING", "")
    for n in [int(x) for x in scaling.split(",") if x.strip()]:
        if n > 0:
            measure(n, f"_lanes_{n}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
