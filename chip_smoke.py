"""Smoke test of x3tpu on an NVIDIA GPU: the product path once, checked
byte for byte against the native host codec.

Usage:  python chip_smoke.py                 one card, phases 1-5
        python chip_smoke.py --four-cards    four cards, the mesh phase only

Everything runs in this one process (a second JAX process on the card
would find its memory reserved).  Phases:

  1. identity: the device JAX reports, the cards' names and power limits
     (nvidia-smi), JAX/jaxlib versions, XLA_FLAGS, the compile cache;
  2. default wave: ``runtime.encode_wave`` / ``decode_wave`` on 32 blocks
     of 16 KiB at the reference defaults (-t 15 -w 8);
  3. archive: ``x3tpu.compress(block_bytes=64 KiB, dict_seed=True)`` and
     ``x3tpu.decompress`` on an 8 MiB corpus (``bench.build_corpus`` text
     with a seeded binary-class last quarter);
  4. CLI: ``cli.main`` ``-z`` on a 256 KiB file (one raw reference-format
     stream), then ``-d``;
  5. observations per phase and direction: compile and run seconds,
     events, us per event, MB/s, peak device memory.  They are smoke
     observations, not benchmark numbers.

``--four-cards`` runs phase 3's archive on a 4-card mesh and on one of the
four cards, requires byte-identical containers and prints the 1->4 time
ratio.

Every payload must equal ``host.encode`` of its block (native/x3host.cpp,
bit-exact with the reference x3 binary) and every round trip must be
exact.  The last stdout line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
a run without a GPU, or with any failed check, exits non-zero without it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import io
import json
import os
import re
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np

# the phases' full sizes
WAVE_BLOCKS, WAVE_BLOCK = 32, 16 << 10
ARCHIVE_BYTES, ARCHIVE_BLOCK = 8 << 20, 64 << 10
CLI_BYTES = 256 << 10
BINARY_SEED = 20260101

COMPILE_EVENTS = (
    "/jax/core/compile/jaxpr_trace_duration",
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",
)
CACHE_HIT_EVENT = "/jax/compilation_cache/cache_hits"


class SmokeFailure(RuntimeError):
    """A phase produced a wrong result."""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling (its own
    compile-duration events) while the context is open, and the number of
    persistent-cache hits among those compiles."""

    def __init__(self) -> None:
        self.seconds = 0.0
        self.cache_hits = 0

    def _on_duration(self, event: str, duration: float, **_kw) -> None:
        if event in COMPILE_EVENTS:
            self.seconds += duration

    def _on_event(self, event: str, **_kw) -> None:
        if event == CACHE_HIT_EVENT:
            self.cache_hits += 1

    def __enter__(self) -> "CompileClock":
        import jax

        jax.monitoring.register_event_duration_secs_listener(self._on_duration)
        jax.monitoring.register_event_listener(self._on_event)
        return self

    def __exit__(self, *exc) -> None:
        import jax

        jax.monitoring.unregister_event_duration_listener(self._on_duration)
        jax.monitoring.unregister_event_listener(self._on_event)


@dataclasses.dataclass
class Observation:
    """One timed call of a phase, in one direction."""

    phase: str
    direction: str
    wall_s: float
    compile_s: float
    cache_hits: int
    events: int
    nbytes: int
    lanes: int

    @property
    def run_s(self) -> float:
        return max(self.wall_s - self.compile_s, 0.0)

    def line(self, card: str) -> str:
        run = self.run_s
        us_ev = 1e6 * run / self.events if self.events else float("nan")
        mbs = self.nbytes / run / 1e6 if run > 0 else float("nan")
        return (f"[{card}] obs phase={self.phase} dir={self.direction} "
                f"compile_s={self.compile_s:.3f} run_s={run:.3f} "
                f"cache_hits={self.cache_hits} events={self.events} "
                f"lanes={self.lanes} us_per_event={us_ev:.3f} "
                f"MB_per_s={mbs:.4f} peak_bytes={peak_bytes()}")


def peak_bytes() -> Optional[int]:
    """Largest ``peak_bytes_in_use`` over the devices since the process
    started (None where the backend keeps no memory statistics)."""
    import jax

    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in jax.devices()]
    peaks = [p for p in peaks if p is not None]
    return max(peaks) if peaks else None


def timed(phase: str, direction: str, nbytes: int, lanes: int, fn):
    """Run ``fn`` (which returns host bytes, so the device is done) and
    return (its result, the Observation without events)."""
    with CompileClock() as clock:
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
    return out, Observation(phase, direction, wall, clock.seconds,
                            clock.cache_hits, 0, nbytes, lanes)


def binary_records(nbytes: int, seed: int) -> bytes:
    """Seeded binary-class data: fixed-width little-endian records (a
    counter, a small category code, a rounded float32 reading, four raw
    bytes), the shape of a table dump or an object file's data section."""
    rng = np.random.default_rng(seed)
    n = nbytes // 16 + 1
    rec = np.zeros(n, dtype=[("id", "<u4"), ("cat", "<u2"), ("pad", "<u2"),
                             ("val", "<f4"), ("raw", "u1", 4)])
    rec["id"] = 1000 + 3 * np.arange(n, dtype=np.uint32)
    rec["cat"] = rng.integers(0, 12, n)
    rec["val"] = np.round(rng.normal(50.0, 10.0, n), 1)
    rec["raw"] = rng.integers(0, 256, (n, 4))
    return rec.tobytes()[:nbytes]


def archive_corpus(nbytes: int) -> bytes:
    """Phase 3's input: bench.build_corpus text, binary-class last quarter."""
    import bench

    quarter = nbytes // 4
    return bench.build_corpus(nbytes - quarter) + binary_records(
        quarter, BINARY_SEED)


def phase_default_wave(nblocks: int = WAVE_BLOCKS,
                       block_bytes: int = WAVE_BLOCK) -> List[Observation]:
    """Phase 2: one wave each way at the reference defaults."""
    import bench
    from x3tpu import host
    from x3tpu.config import X3Params
    from x3tpu.parallel import runtime

    params = X3Params()
    data = bench.build_corpus(nblocks * block_bytes)
    blocks = [data[i * block_bytes:(i + 1) * block_bytes]
              for i in range(nblocks)]
    caps = runtime.caps_for_block(block_bytes)
    enc, o_enc = timed("wave", "encode", len(data), nblocks,
                       lambda: runtime.encode_wave(blocks, params, caps))
    for i, b in enumerate(blocks):
        check(enc.payloads[i] == host.encode(b, params),
              f"wave block {i}: stream differs from host.encode")
    dec, o_dec = timed("wave", "decode", len(data), nblocks,
                       lambda: runtime.decode_wave(
                           enc.payloads, [len(b) for b in blocks], params,
                           caps))
    check(dec.payloads == blocks, "wave decode differs from the input")
    o_enc.events = int(enc.stats.events.sum())
    o_dec.events = int(dec.stats.events.sum())
    return [o_enc, o_dec]


def _archive(data: bytes, block_bytes: int, mesh, phase: str):
    """compress + decompress one archive; every payload checked against
    the seeded host codec.  Returns (container, observations)."""
    import x3tpu
    from x3tpu import host
    from x3tpu.parallel import blocks as blk

    nblocks = -(-len(data) // block_bytes)
    lanes = min(nblocks, 32 * (mesh.devices.size if mesh is not None else 1))
    st_enc: list = []
    c, o_enc = timed(phase, "encode", len(data), lanes,
                     lambda: x3tpu.compress(data, block_bytes=block_bytes,
                                            dict_seed=True, mesh=mesh,
                                            stats_out=st_enc))
    payloads, orig_lens, _bb, seed_bytes, _tape = blk.unpack_container(c)
    check(len(payloads) == nblocks and seed_bytes,
          f"{phase}: container holds {len(payloads)} blocks, "
          f"{len(seed_bytes)} seeds")
    strs = np.zeros((len(seed_bytes), 32), np.uint8)
    lens = np.asarray([len(s) for s in seed_bytes], np.int32)
    for i, s in enumerate(seed_bytes):
        strs[i, :len(s)] = np.frombuffer(s, np.uint8)
    for i in range(nblocks):
        block = data[i * block_bytes:(i + 1) * block_bytes]
        check(payloads[i] == host.encode(block, seeds=(strs, lens)),
              f"{phase} block {i}: stream differs from seeded host.encode")
    st_dec: list = []
    back, o_dec = timed(phase, "decode", len(data), lanes,
                        lambda: x3tpu.decompress(c, mesh=mesh,
                                                 stats_out=st_dec))
    check(back == data, f"{phase}: round trip differs from the input")
    o_enc.events = int(st_enc[0].events.sum())
    o_dec.events = int(st_dec[0].events.sum())
    return c, [o_enc, o_dec]


def phase_archive(nbytes: int = ARCHIVE_BYTES,
                  block_bytes: int = ARCHIVE_BLOCK) -> List[Observation]:
    """Phase 3: a seeded multi-wave archive at a real block size."""
    return _archive(archive_corpus(nbytes), block_bytes, None, "archive")[1]


def phase_cli(nbytes: int = CLI_BYTES) -> List[Observation]:
    """Phase 4: the reference-compatible CLI, in process, on one file."""
    import bench
    from x3tpu import cli, host

    data = bench.build_corpus(nbytes)
    obs = []
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "input.bin")
        with open(src, "wb") as f:
            f.write(data)
        for direction, argv, out in (
            ("encode", ["-z", "-f", src], src + ".x3"),
            ("decode", ["-d", "-f", src + ".x3", src + ".out"],
             src + ".out"),
        ):
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc, o = timed("cli", direction, len(data), 1,
                              lambda: cli.main(argv))
            sys.stderr.write(err.getvalue())
            check(rc == 0, f"cli {direction} exited {rc}")
            m = re.search(r"number of events: ctx0 (\d+), ctx1 (\d+), "
                          r"miss1 (\d+), new (\d+)", err.getvalue())
            check(m is not None, f"cli {direction}: no stats report")
            o.events = sum(int(g) for g in m.groups())
            obs.append(o)
            with open(out, "rb") as f:
                got = f.read()
            if direction == "encode":
                check(got == host.encode(data),
                      "cli stream differs from host.encode")
            else:
                check(got == data, "cli round trip differs from the input")
    return obs


def phase_four_cards(nbytes: int = ARCHIVE_BYTES,
                     block_bytes: int = ARCHIVE_BLOCK,
                     ndev: int = 4) -> List[Observation]:
    """The archive on an ``ndev``-card mesh against the same archive on
    one of those cards; the containers must be byte-identical."""
    from x3tpu.parallel import mesh as meshmod

    data = archive_corpus(nbytes)
    mesh = meshmod.make_mesh(ndev)
    one, obs1 = _archive(data, block_bytes, None, "archive-1card")
    many, obsn = _archive(data, block_bytes, mesh, f"archive-{ndev}card")
    check(many == one, f"{ndev}-card container differs from the 1-card one")
    for o1, on in zip(obs1, obsn):
        print(f"scaling dir={o1.direction} run_s_1card={o1.run_s:.3f} "
              f"run_s_{ndev}card={on.run_s:.3f} "
              f"ratio_1_to_{ndev}={o1.run_s / max(on.run_s, 1e-9):.3f}")
    return obs1 + obsn


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the archive on a 4-card mesh against "
                         "one card")
    args = ap.parse_args(argv)

    import jax
    import jaxlib

    from x3tpu.utils import device

    cache_dir = device.enable_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU: JAX runs on {devs[0].platform!r}",
              file=sys.stderr)
        return 2
    need = 4 if args.four_cards else 1
    if len(devs) < need:
        print(f"chip_smoke: needs {need} GPUs, JAX sees {len(devs)}",
              file=sys.stderr)
        return 2

    smi = device.nvidia_smi()
    card = smi.splitlines()[0]
    print(f"device_kind: {devs[0].device_kind} (count {len(devs)})")
    print(f"nvidia-smi: {smi}")
    print(f"jax {jax.__version__} jaxlib {jaxlib.__version__}")
    print(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}")
    print(f"compile cache: {cache_dir}")
    print(f"archive corpus sha256: "
          f"{hashlib.sha256(archive_corpus(ARCHIVE_BYTES)).hexdigest()[:16]}")
    sys.stdout.flush()

    if args.four_cards:
        phases = [("four-cards", phase_four_cards)]
    else:
        phases = [("wave", phase_default_wave), ("archive", phase_archive),
                  ("cli", phase_cli)]
    for name, fn in phases:
        t0 = time.perf_counter()
        for o in fn():
            print(o.line(card), flush=True)
        print(f"phase {name}: ok in {time.perf_counter() - t0:.1f}s",
              flush=True)

    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
