"""At-scale bit-exactness: native host codec vs the reference binary on a
~1 MB mixed corpus (gated: set X3TPU_SLOW=1; runs in ~30s)."""

import os
import subprocess

import numpy as np
import pytest

from x3tpu import host
from x3tpu.config import X3Params

pytestmark = pytest.mark.skipif(
    os.environ.get("X3TPU_SLOW") != "1", reason="set X3TPU_SLOW=1"
)


def _corpus(total: int) -> bytes:
    from conftest import C_TEXT

    parts = [C_TEXT.read_bytes()]
    rng = np.random.default_rng(5)
    parts.append(rng.integers(0, 256, 50_000, np.uint8).tobytes())
    parts.append(bytes(rng.choice(list(b"abcdef \n"), 100_000)))
    blob = b"".join(parts)
    return (blob * (total // len(blob) + 1))[:total]


def test_megabyte_bit_exact(ref_binary, tmp_path):
    data = _corpus(1 << 20)
    params = X3Params(max_match_count=4, window=1024)
    raw = tmp_path / "in.bin"
    raw.write_bytes(data)
    ref_x3 = tmp_path / "in.ref.x3"
    subprocess.run(
        [str(ref_binary), "-zf", "-t", "4", "-w", "1", str(raw), str(ref_x3)],
        check=True, capture_output=True,
    )
    ref_stream = ref_x3.read_bytes()
    ours = host.encode(data, params)
    assert ours == ref_stream, f"{len(ours)} vs {len(ref_stream)}"
    assert host.decode(ref_stream, max_output=1 << 22) == data
