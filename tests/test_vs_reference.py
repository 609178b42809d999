"""Two-way interop with the reference binary, built from $X3_REFERENCE_SRC
at test time, across a randomized parameter sweep (beyond the golden fixtures).

Uses the native host codec as "our" side (bit-exact vs spec and the JAX
codec by the other suites) so the sweep runs at full speed.
"""

import subprocess

import numpy as np
import pytest

from x3tpu import host
from x3tpu.config import X3Params

from conftest import GOLDEN

try:
    host.encode(b"probe")
    HAVE = True
except host.HostCodecUnavailable:
    HAVE = False

pytestmark = pytest.mark.skipif(not HAVE, reason="no g++ toolchain")


SWEEP = [
    X3Params(max_match_count=1, window=1024),
    X3Params(max_match_count=2, window=2048, magic_factor1=0),
    X3Params(max_match_count=7, window=1024, magic_factor1=2),
    X3Params(max_match_count=15, window=4096),
    X3Params(max_match_count=3, window=1024, magic_factor2=3),
    X3Params(max_match_count=5, window=2048, nl_remap=True),
    X3Params(max_match_count=31, window=1024),
]


def _ref_args(p: X3Params):
    args = ["-t", str(p.max_match_count), "-w", str(p.window // 1024),
            "-m", str(p.magic_factor1), "-n", str(p.magic_factor2)]
    if p.nl_remap:
        args.append("-x")
    return args


def _inputs():
    rng = np.random.default_rng(7)
    text = (GOLDEN / "c_source.bin").read_bytes()
    return {
        "text": text[:12000],
        "mixed": text[:4000] + rng.integers(0, 256, 3000, np.uint8).tobytes(),
        "lowent": bytes(rng.choice(list(b"abcd \n"), 8000)),
    }


@pytest.mark.parametrize("pidx", range(len(SWEEP)))
def test_interop_sweep(pidx, ref_binary, tmp_path):
    params = SWEEP[pidx]
    for name, data in _inputs().items():
        raw = tmp_path / f"{name}.bin"
        raw.write_bytes(data)
        # reference encode -> our decode
        ref_x3 = tmp_path / f"{name}.ref.x3"
        subprocess.run(
            [str(ref_binary), "-zf", *_ref_args(params), str(raw), str(ref_x3)],
            check=True, capture_output=True,
        )
        ref_stream = ref_x3.read_bytes()
        assert host.decode(ref_stream, max_output=1 << 22) == data, (
            f"{name}: our decode of reference stream"
        )
        # our encode must be bit-identical to the reference's
        ours = host.encode(data, params)
        assert ours == ref_stream, (
            f"{name}: stream mismatch ({len(ours)} vs {len(ref_stream)})"
        )
        # ...and therefore the reference binary decodes it (spot-check)
        our_x3 = tmp_path / f"{name}.our.x3"
        our_x3.write_bytes(ours)
        out = tmp_path / f"{name}.out"
        subprocess.run(
            [str(ref_binary), "-df", str(our_x3), str(out)],
            check=True, capture_output=True,
        )
        assert out.read_bytes() == data
