"""Native host codec: bit-exact vs golden reference streams and the spec."""

import numpy as np
import pytest

from x3tpu import host, spec
from x3tpu.config import X3Params

from conftest import C_TEXT, GOLDEN, PARAMSETS, golden_cases

try:
    host.encode(b"probe")
    HAVE = True
except host.HostCodecUnavailable:
    HAVE = False

pytestmark = pytest.mark.skipif(not HAVE, reason="no g++ toolchain")


@pytest.mark.parametrize("name,pname", golden_cases())
def test_host_encode_matches_reference(name, pname):
    data = (GOLDEN / f"{name}.bin").read_bytes()
    golden = (GOLDEN / f"{name}.{pname}.x3").read_bytes()
    ours = host.encode(data, X3Params(**PARAMSETS[pname]))
    assert ours == golden


@pytest.mark.parametrize("name,pname", golden_cases())
def test_host_decode_reference_stream(name, pname):
    data = (GOLDEN / f"{name}.bin").read_bytes()
    golden = (GOLDEN / f"{name}.{pname}.x3").read_bytes()
    assert host.decode(golden) == data


def test_host_large_roundtrip():
    """Bigger-than-golden input: host codec vs spec on 60 KB of mixed data."""
    rng = np.random.default_rng(42)
    text = C_TEXT.read_bytes()[:20000]
    data = text + rng.integers(0, 256, 8000, dtype=np.uint8).tobytes() + text
    params = X3Params(max_match_count=8, window=2048)
    stream = host.encode(data, params)
    assert stream == spec.encode(data, params)
    assert host.decode(stream) == data


def test_host_high_ratio_decode():
    data = b"\x00" * 100_000
    stream = host.encode(data, X3Params(max_match_count=4, window=1024))
    assert host.decode(stream, max_output=1 << 20) == data


def test_host_decode_cap_autogrow():
    """A >64:1 stream with the default cap must auto-grow, not abort the
    process (x3h_decode rc=2 contract; the old code called abort())."""
    data = bytes(1 << 20)
    stream = host.encode(data)  # ratio ~2880:1, beyond the 64:1 guess
    assert host.decode(stream) == data


def test_host_decode_errors_raise():
    """Corrupt streams and too-small explicit caps raise RuntimeError
    instead of killing the embedding process."""
    import pytest

    with pytest.raises(RuntimeError):
        host.decode(b"\xff" * 64, max_output=1 << 16)
    stream = host.encode(b"payload " * 400)
    with pytest.raises(RuntimeError):
        host.decode(stream, max_output=8)


def test_host_seeded_matches_jax_and_roundtrips():
    """Seeded host encode/decode (x3h_encode_seeded) is bit-exact vs the
    seeded JAX codec (codec.py:_init_shared seed broadcast) and improves
    the ratio over unseeded on a same-domain block."""
    import jax.numpy as jnp

    from x3tpu import codec
    from x3tpu.config import CodecCaps

    params = X3Params(max_match_count=8, window=512)
    text = C_TEXT.read_bytes()[:20000]
    strs, lens = host.train_seeds(text[:4000], params, 64)
    blk = text[4000:12000]

    plain = host.encode(blk, params)
    seeded = host.encode(blk, params, seeds=(strs, lens))
    assert host.decode(seeded, seeds=(strs, lens)) == blk
    assert len(seeded) < len(plain)

    caps = CodecCaps(dict_cap=512, pair_cap=2048, ctx_items_cap=128,
                     ctx0_items_cap=128, block_bytes=8192)
    t, tl = codec.pack_blocks([blk], params, caps)
    w, bl, *_ = codec.encode_blocks_chunked(
        jnp.asarray(t), jnp.asarray(tl), params, caps,
        seeds=(jnp.asarray(strs), jnp.asarray(lens)),
    )
    import numpy as np

    s_jax = np.asarray(w)[0].astype("<u4").tobytes()[: int(np.asarray(bl)[0])]
    assert s_jax == seeded


def test_host_decode_corrupt_stream_raises():
    """Corrupt streams must surface RuntimeError through the C ABI, not
    UB (round 5: a corrupt stream segfaulted via an out-of-range context
    id, and a div-by-zero SIGFPE'd the whole process before that)."""
    import random

    data = b"corrupt robustness: the quick brown fox " * 40
    s = host.encode(data)
    assert host.decode(s) == data
    rng = random.Random(7)
    crashes = 0
    for _ in range(60):
        b = bytearray(s)
        for _ in range(8):
            b[rng.randrange(len(b))] ^= rng.randrange(1, 256)
        try:
            host.decode(bytes(b), max_output=1 << 16)
        except RuntimeError:
            crashes += 1
    # most corruptions must be detected (a few may decode to garbage
    # within the cap without tripping a guard — that is permitted)
    assert crashes > 0
