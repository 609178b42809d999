"""CLI end-to-end tests (subprocess, CPU backend) including stats-counter
parity against the reference binary's stderr report."""

import os
import re
import subprocess
import sys

import pytest

from conftest import GOLDEN, ROOT

ENV = dict(os.environ, JAX_PLATFORMS="cpu",
           XLA_FLAGS="--xla_force_host_platform_device_count=8")


def _run_cli(args, data=None):
    return subprocess.run(
        [sys.executable, "-m", "x3tpu", *args],
        input=data, capture_output=True, env=ENV, cwd=ROOT,
        timeout=600,
    )


def test_cli_roundtrip_files(tmp_path):
    data = (GOLDEN / "text_small.bin").read_bytes()
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    r = _run_cli(["-z", "-t", "4", "-w", "1", str(src)])
    assert r.returncode == 0, r.stderr.decode()
    assert (tmp_path / "in.bin.x3").exists()
    # overwrite guard (file.c:47-55 behavior)
    r2 = _run_cli(["-z", "-t", "4", "-w", "1", str(src)])
    assert r2.returncode == 1
    assert b"already exists" in r2.stderr
    # decompress with suffix strip
    os.unlink(src)
    r3 = _run_cli(["-d", str(tmp_path / "in.bin.x3")])
    assert r3.returncode == 0, r3.stderr.decode()
    assert src.read_bytes() == data


def test_cli_decompress_suffixless_refuses(tmp_path):
    """`-d -f file-without-suffix` must NOT derive the output name as the
    input itself (open-for-write would truncate it before the read)."""
    src = tmp_path / "noext"
    src.write_bytes(b"precious original bytes")
    r = _run_cli(["-d", "-f", str(src)])
    assert r.returncode == 1
    assert src.read_bytes() == b"precious original bytes"


def test_cli_stdin_stdout():
    data = b"stdin roundtrip payload " * 40
    rz = _run_cli(["-z", "-t", "4", "-w", "1", "-q"], data=data)
    assert rz.returncode == 0, rz.stderr.decode()
    rd = _run_cli(["-d", "-q"], data=rz.stdout)
    assert rd.returncode == 0, rd.stderr.decode()
    assert rd.stdout == data


def test_cli_stats_match_reference(ref_binary, tmp_path):
    """Our stats block's event counters must equal the reference's own
    stderr report for the same file and parameters (x3.c:684-685)."""
    data = (GOLDEN / "text_small.bin").read_bytes()
    src = tmp_path / "s.bin"
    src.write_bytes(data)
    ref = subprocess.run(
        [str(ref_binary), "-zf", "-t", "4", "-w", "1", str(src),
         str(tmp_path / "s.ref.x3")],
        capture_output=True, timeout=300,
    )
    ours = _run_cli(["-z", "-f", "-t", "4", "-w", "1", str(src),
                     str(tmp_path / "s.our.x3")])
    pat = re.compile(
        rb"number of events: ctx0 (\d+), ctx1 (\d+), miss1 (\d+), new (\d+)"
    )
    mref = pat.search(ref.stderr)
    mour = pat.search(ours.stderr)
    assert mref and mour, (ref.stderr, ours.stderr)
    assert mref.groups() == mour.groups()
    assert (tmp_path / "s.ref.x3").read_bytes() == (
        (tmp_path / "s.our.x3").read_bytes()
    )


def test_cli_decode_stats_match_reference(ref_binary, tmp_path):
    """Decode-side event counters must also equal the reference's stderr
    report for the same stream (the reference never counts E_EOF in
    events[] in either direction; regression for the decoder drift)."""
    data = (GOLDEN / "text_small.bin").read_bytes()
    src = tmp_path / "d.bin"
    src.write_bytes(data)
    ref_z = subprocess.run(
        [str(ref_binary), "-zf", "-t", "4", "-w", "1", str(src),
         str(tmp_path / "d.x3")],
        capture_output=True, timeout=300,
    )
    assert ref_z.returncode == 0
    ref_d = subprocess.run(
        [str(ref_binary), "-df", str(tmp_path / "d.x3"),
         str(tmp_path / "d.ref.out")],
        capture_output=True, timeout=300,
    )
    our_d = _run_cli(["-d", "-f", str(tmp_path / "d.x3"),
                      str(tmp_path / "d.our.out")])
    assert our_d.returncode == 0, our_d.stderr.decode()
    pat = re.compile(
        rb"number of events: ctx0 (\d+), ctx1 (\d+), miss1 (\d+), new (\d+)"
    )
    mref = pat.search(ref_d.stderr)
    mour = pat.search(our_d.stderr)
    assert mref and mour, (ref_d.stderr, our_d.stderr)
    assert mref.groups() == mour.groups()
    assert (tmp_path / "d.our.out").read_bytes() == data


def test_cli_container_mode(tmp_path):
    data = (GOLDEN / "c_source.bin").read_bytes()
    src = tmp_path / "c.bin"
    src.write_bytes(data)
    r = _run_cli(["-z", "-f", "-t", "4", "-w", "1", "--block-size", "2",
                  "--devices", "4", str(src), str(tmp_path / "c.x3c")])
    assert r.returncode == 0, r.stderr.decode()
    assert (tmp_path / "c.x3c").read_bytes()[:4] == b"X3TC"
    r2 = _run_cli(["-d", "-f", str(tmp_path / "c.x3c"), str(tmp_path / "c.out")])
    assert r2.returncode == 0, r2.stderr.decode()
    assert (tmp_path / "c.out").read_bytes() == data
