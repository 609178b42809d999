"""chip_smoke.py: its phases at tiny sizes on the CPU backend, the
four-card phase on four virtual CPU devices, and its refusal to run
without a GPU.  The full-size run needs a card (the ``gpu`` marker)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke
from conftest import ROOT


def _env(**kw):
    env = dict(os.environ, **kw)
    return {k: v for k, v in env.items() if v is not None}


def _run(args, cwd=ROOT, **env):
    return subprocess.run([sys.executable, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=600,
                          env=_env(**env))


def _check_obs(obs, phase, nbytes):
    assert [o.direction for o in obs] == ["encode", "decode"]
    for o in obs:
        assert o.phase == phase and o.nbytes == nbytes
        assert o.events > 0 and o.wall_s >= o.compile_s >= 0
        line = o.line("card X, 1 W")
        assert line.startswith("[card X, 1 W] obs phase=" + phase)
        assert f"events={o.events}" in line


def test_phase_default_wave_tiny():
    obs = chip_smoke.phase_default_wave(nblocks=2, block_bytes=2048)
    _check_obs(obs, "wave", 2 * 2048)


def test_phase_archive_tiny():
    obs = chip_smoke.phase_archive(nbytes=8192, block_bytes=2048)
    _check_obs(obs, "archive", 8192)


def test_phase_cli_tiny():
    obs = chip_smoke.phase_cli(nbytes=3000)
    _check_obs(obs, "cli", 3000)


def test_four_cards_on_virtual_devices():
    """The --four-cards phase on 4 of the test mesh's virtual CPU devices:
    the 4-device container must equal the 1-device one (checked inside)."""
    obs = chip_smoke.phase_four_cards(nbytes=8192, block_bytes=2048, ndev=4)
    assert [o.phase for o in obs] == ["archive-1card"] * 2 + [
        "archive-4card"] * 2


def test_archive_corpus_is_deterministic():
    a = chip_smoke.archive_corpus(1 << 16)
    assert a == chip_smoke.archive_corpus(1 << 16) and len(a) == 1 << 16
    assert a[-(1 << 14):] == chip_smoke.binary_records(
        1 << 14, chip_smoke.BINARY_SEED)


def test_refuses_without_gpu():
    r = _run(["chip_smoke.py"], JAX_PLATFORMS="cpu")
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_refuses_alone_in_a_directory(tmp_path):
    """Copied out of the repo the script cannot import the program, so it
    fails and prints no result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(["chip_smoke.py"], cwd=tmp_path, PYTHONPATH=None)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.gpu
def test_chip_smoke_on_card(gpu_card):
    """The full smoke run on the card, in a child process that is the
    card's only JAX process (this one stays on the CPU)."""
    r = _run(["chip_smoke.py"], JAX_PLATFORMS=None, XLA_FLAGS=None)
    assert r.returncode == 0, r.stderr[-3000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
