"""Multi-device tests on the virtual 8-device CPU mesh: sharded codec
execution, container format, wave scheduling, auto-retry."""

import dataclasses

import numpy as np
import pytest

import jax

from x3tpu import codec, spec
from x3tpu.config import CodecCaps, X3Params
from x3tpu.parallel import blocks as blk
from x3tpu.parallel import mesh as meshmod
from x3tpu.parallel import runtime

PARAMS = X3Params(max_match_count=4, window=1024)
CAPS = CodecCaps(dict_cap=512, pair_cap=4096, ctx_items_cap=128, block_bytes=4096)


def _blocks(n, size=1800, seed=0):
    rng = np.random.default_rng(seed)
    base = (b"the quick brown fox jumps over the lazy dog. " * 200)
    out = []
    for i in range(n):
        start = int(rng.integers(0, 100))
        out.append(base[start : start + size])
    return out


def test_container_roundtrip():
    payloads = [b"abc", b"", b"payload-two"]
    lens = [10, 0, 22]
    c = blk.pack_container(payloads, lens, 4096)
    assert blk.is_container(c)
    p2, l2, bs, seeds, _wt = blk.unpack_container(c)
    assert p2 == payloads and l2 == lens and bs == 4096 and seeds == []

    c2 = blk.pack_container(payloads, lens, 4096, seeds=[b"abc", b"x" * 32])
    p3, l3, _, seeds2, _wt2 = blk.unpack_container(c2)
    assert p3 == payloads and seeds2 == [b"abc", b"x" * 32]


def test_split_blocks():
    data = bytes(range(10))
    assert blk.split_blocks(data, 4) == [data[0:4], data[4:8], data[8:10]]
    assert blk.split_blocks(b"", 4) == [b""]


def test_sharded_encode_matches_unsharded():
    """8 blocks sharded over the 8-device CPU mesh produce bit-identical
    streams to the single-device path."""
    mesh = meshmod.make_mesh()
    assert mesh.devices.size == 8, "conftest should provide 8 CPU devices"
    blocks = _blocks(8)
    text, tlen = codec.pack_blocks(blocks, PARAMS, CAPS)
    w_s, l_s, _, _, of_s = meshmod.encode_sharded(text, tlen, PARAMS, CAPS, mesh)
    w_u, l_u, _, _, of_u = codec.encode_blocks_jit(
        jax.numpy.asarray(text), jax.numpy.asarray(tlen), PARAMS, CAPS
    )
    assert not bool(of_s.any_flag().any())
    np.testing.assert_array_equal(np.asarray(l_s), np.asarray(l_u))
    np.testing.assert_array_equal(np.asarray(w_s), np.asarray(w_u))


def test_runtime_compress_decompress_container():
    data = b"".join(_blocks(5, 1500))
    mesh = meshmod.make_mesh()
    out = runtime.compress(data, PARAMS, block_bytes=2048, caps=CAPS, mesh=mesh)
    assert blk.is_container(out)
    back = runtime.decompress(out, PARAMS, caps=CAPS, mesh=mesh)
    assert back == data


def test_package_toplevel_api():
    """x3tpu.compress/x3tpu.decompress are the one-call library API (lazy
    re-exports of parallel.runtime; importing x3tpu must not pull jax)."""
    import x3tpu

    data = _blocks(1, 1400)[0]
    out = x3tpu.compress(data, PARAMS, caps=CAPS)
    assert x3tpu.decompress(out, PARAMS, caps=CAPS) == data
    assert x3tpu.compress is runtime.compress
    with pytest.raises(AttributeError):
        x3tpu.no_such_attr


def test_runtime_single_block_is_reference_format():
    data = _blocks(1, 1200)[0]
    out = runtime.compress(data, PARAMS, caps=CAPS)
    assert not blk.is_container(out)
    assert out == spec.encode(data, PARAMS)
    assert runtime.decompress(out, PARAMS, caps=CAPS) == data


def test_runtime_capacity_autoretry():
    tiny = CodecCaps(dict_cap=8, pair_cap=16, ctx_items_cap=8, block_bytes=4096)
    data = _blocks(1, 3000)[0]
    out = runtime.compress(data, PARAMS, caps=tiny)
    assert out == spec.encode(data, PARAMS)


def test_runtime_stats():
    data = _blocks(1, 2000)[0]
    stats_box = []
    out = runtime.compress(data, PARAMS, caps=CAPS, stats_out=stats_box)
    st = stats_box[0]
    assert st.dict_hits + int(st.events[3]) > 0
    est = st.estimated_bytes
    assert abs(est - len(out)) / len(out) < 0.05
    rep = st.report(len(data), len(out), 0.1)
    assert "compression ratio" in rep


def test_dict_seed_roundtrip_and_ratio():
    """Seeded multi-block compression round-trips and beats unseeded ratio
    on redundant data split into small blocks."""
    from conftest import C_TEXT

    base = C_TEXT.read_bytes()[:12000]
    out_plain = runtime.compress(base, PARAMS, block_bytes=1500, caps=CAPS)
    out_seeded = runtime.compress(
        base, PARAMS, block_bytes=1500, caps=CAPS, dict_seed=True, seed_k=128
    )
    assert runtime.decompress(out_seeded, PARAMS, caps=CAPS) == base
    assert runtime.decompress(out_plain, PARAMS, caps=CAPS) == base
    assert len(out_seeded) < len(out_plain), (
        f"seeded {len(out_seeded)} !< plain {len(out_plain)}"
    )


def test_dict_seed_sharded():
    mesh = meshmod.make_mesh()
    base = (b"0123456789 abcdefgh " * 400)
    out = runtime.compress(
        base, PARAMS, block_bytes=1024, caps=CAPS, mesh=mesh, dict_seed=True,
        seed_k=64,
    )
    assert runtime.decompress(out, PARAMS, caps=CAPS, mesh=mesh) == base


def test_journal_resume(tmp_path):
    """Wave journal: interrupt after the first wave, resume produces an
    identical container without re-encoding completed waves."""
    data = b"".join(_blocks(6, 1200, seed=3))
    jpath = str(tmp_path / "job.journal")
    mesh = meshmod.make_mesh(2)

    full = runtime.compress(data, PARAMS, block_bytes=1024, caps=CAPS,
                            mesh=mesh, lanes_per_device=2)

    # run with a journal, then simulate a crash by monkeypatching
    # encode_wave to fail after wave 0
    calls = {"n": 0}
    orig = runtime.encode_wave

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] > 1:
            raise RuntimeError("simulated device loss")
        return orig(*a, **kw)

    runtime.encode_wave = flaky
    try:
        import pytest as _pytest

        with _pytest.raises(RuntimeError):
            runtime.compress(data, PARAMS, block_bytes=1024, caps=CAPS,
                             mesh=mesh, journal_path=jpath,
                             lanes_per_device=2)
    finally:
        runtime.encode_wave = orig

    # resume: completes and matches the uninterrupted container, and the
    # reported stats cover journal-resumed waves too (stored per wave)
    full_stats: list = []
    runtime.compress(data, PARAMS, block_bytes=1024, caps=CAPS, mesh=mesh,
                     lanes_per_device=2, stats_out=full_stats)
    resumed_stats: list = []
    resumed = runtime.compress(data, PARAMS, block_bytes=1024, caps=CAPS,
                               mesh=mesh, journal_path=jpath,
                               lanes_per_device=2, stats_out=resumed_stats)
    assert resumed == full
    assert runtime.decompress(resumed, PARAMS, caps=CAPS) == data
    np.testing.assert_array_equal(resumed_stats[0].events,
                                  full_stats[0].events)
    import os
    assert not os.path.exists(jpath)  # journal removed on success


def test_journal_wave_width_mismatch(tmp_path):
    """A journal written at one wave width must NOT be spliced into a run
    with a different width (the wave->block mapping shifts): the
    fingerprint includes the partitioning, so the mismatched resume simply
    re-encodes everything and still produces the right container."""
    data = b"".join(_blocks(6, 1200, seed=5))
    jpath = str(tmp_path / "job.journal")
    mesh = meshmod.make_mesh(2)
    full = runtime.compress(data, PARAMS, block_bytes=1024, caps=CAPS,
                            mesh=mesh, lanes_per_device=2)

    calls = {"n": 0}
    orig = runtime.encode_wave

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] > 1:
            raise RuntimeError("simulated device loss")
        return orig(*a, **kw)

    runtime.encode_wave = flaky
    try:
        with pytest.raises(RuntimeError):
            runtime.compress(data, PARAMS, block_bytes=1024, caps=CAPS,
                             mesh=mesh, journal_path=jpath,
                             lanes_per_device=2)
    finally:
        runtime.encode_wave = orig

    # resume at a DIFFERENT wave width: journal ignored, output correct
    resumed = runtime.compress(data, PARAMS, block_bytes=1024, caps=CAPS,
                               mesh=mesh, journal_path=jpath,
                               lanes_per_device=3)
    assert resumed == full
    assert runtime.decompress(resumed, PARAMS, caps=CAPS) == data


def test_encode_wave_output_overflow_retry():
    """An output-buffer overflow (stream larger than out_words) must grow
    the headroom on retry, not re-run into the identical flag."""
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, 512, np.uint8).tobytes()  # incompressible
    caps = dataclasses.replace(CAPS, block_bytes=512, out_words_factor=1)
    res = runtime.encode_wave([data], PARAMS, caps)
    out = res.payloads[0]
    assert len(out) > len(data)  # expansion is what forced the overflow
    assert runtime.decompress(out, PARAMS, caps=CAPS) == data


def test_pack_container_length_mismatch():
    with pytest.raises(ValueError):
        blk.pack_container([b"abc"], [3, 4], 1024)


def test_distributed_single_process():
    """Multi-host helpers degrade to identity in a single process."""
    from x3tpu.parallel import distributed as dist

    assert dist.init_multihost() == 0
    mesh = dist.global_mesh()
    assert mesh.devices.size == 8
    payloads = [b"alpha", b"", b"gamma-payload"]
    out = dist.gather_payloads_in_order(payloads, 0, 3)
    assert out == payloads


def test_distributed_two_processes(tmp_path):
    """Real 2-process jax.distributed cluster on localhost CPU: global
    device view, per-host encode, in-order variable-length payload gather
    on process 0 with a decode check of every lane (P2/A7)."""
    import os
    import pathlib
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = str(pathlib.Path(__file__).parent / "multihost_worker.py")
    env = dict(
        os.environ,
        XLA_FLAGS="--xla_force_host_platform_device_count=1",
        JAX_PLATFORMS="",
    )
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", str(port), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"proc {i}:\n{outs[i].decode()[-3000:]}"
    assert (tmp_path / "ok").read_text() == "ok"


def test_profiling_trace(tmp_path):
    """jax.profiler device-trace helper captures a codec run."""
    from x3tpu.utils import profiling

    data = b"profile me " * 50
    with profiling.trace(str(tmp_path)):
        runtime.compress(data, PARAMS, caps=CAPS)
    import os

    found = any("xplane" in f or "trace" in f.lower()
                for _, _, fs in os.walk(tmp_path) for f in fs)
    assert found, "no trace artifacts written"
