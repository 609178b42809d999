"""The product event loop (runtime.encode_wave / decode_wave over the XLA
codec) against the spec oracle, across the configurations that stress
its state machinery: seeded dictionaries, a 32 KiB window on a small
block, long streams, promoted context rows, rows past their capacity
(overflow auto-retry), the -n veto factor, and the sharded mesh.

Every case encodes in one wave, requires each stream to equal the
oracle's byte for byte, decodes the streams back in one wave and
requires the input."""

import dataclasses

import numpy as np
import pytest

from x3tpu import host, spec
from x3tpu.config import CodecCaps, X3Params
from x3tpu.parallel import mesh as meshmod
from x3tpu.parallel import runtime

from conftest import GOLDEN

PARAMS = X3Params(max_match_count=4, window=256)
CAPS = CodecCaps(dict_cap=1024, pair_cap=2048, ctx_items_cap=128,
                 ctx0_items_cap=128, ctx_small_cap=16, block_bytes=2048)


def _mixed_blocks():
    golden = (GOLDEN / "text_small.bin").read_bytes()
    rng = np.random.default_rng(7)
    return [
        b"abracadabra " * 40,
        b"",
        golden[:1200],
        rng.integers(0, 256, 400, np.uint8).tobytes(),
        b"A",
        b"\x00" * 1200,
    ]


def _alphabet64(n=8192):
    # random bytes over a 64-symbol alphabet: every symbol recurs ~n/64
    # times with up to 64 distinct successors, so many non-hub ctx1 rows
    # outgrow the 16-item small pool and are promoted to big rows
    rng = np.random.default_rng(11)
    return rng.integers(1, 65, n, np.uint8).tobytes()


def _wide_rows():
    # one non-hub ctx1 row and one ctx0 row collect ~230 distinct
    # successor tags: window=32 leaves no window matcher, so after the
    # single-byte prelude every event is a dict hit, and each round
    # ``X Y ci`` appends ci to ctx1[Y] and to ctx0[(X,Y)]
    pre = bytes(range(1, 251))
    return pre + b"".join(bytes([251, 252, c]) for c in range(1, 231))


@dataclasses.dataclass
class Case:
    blocks: list
    params: X3Params = PARAMS
    caps: CodecCaps = CAPS
    seeds: list = None        # seed fragments (container seeds)
    mesh_devices: int = 0     # 0 = single device
    promoted: bool = False    # the data must promote context rows


CASES = {
    "default_blocks": Case(_mixed_blocks()),
    "seeded_dictionary": Case(
        [b"abracadabra abracadabra the quick fox " * 12,
         b"no seed overlap here: 123456789 " * 10],
        caps=dataclasses.replace(CAPS, dict_cap=512, pair_cap=1024),
        seeds=[b"abracadabra ", b"the quick ", b"fox", b"\x00\x01\x02"]),
    "window_32k_small_block": Case(
        [b"abcabcabc 0123456789 " * 40, bytes(range(128)) * 2],
        params=X3Params(max_match_count=15, window=32 * 1024),
        caps=CodecCaps(dict_cap=256, pair_cap=512, ctx_items_cap=128,
                       ctx0_items_cap=128, block_bytes=1024)),
    "long_streams": Case(
        # a ~7 KB stream from random bytes (every one-byte hit registers
        # a pair) and a long redundant one
        [np.random.default_rng(3).integers(0, 256, 6000,
                                            np.uint8).tobytes(),
         (b"the quick brown fox " * 300)[:6000]],
        caps=dataclasses.replace(CAPS, pair_cap=8192, block_bytes=6144)),
    "promoted_rows": Case(
        [_alphabet64()],
        caps=dataclasses.replace(CAPS, pair_cap=8192, ctx_items_cap=256,
                                 ctx0_items_cap=256, block_bytes=8192),
        promoted=True),
    "rows_past_caps_retry": Case(
        # rows pass 48 items: the first attempt flags the overflow and
        # the wave re-runs at doubled capacities
        [_alphabet64()],
        caps=CodecCaps(dict_cap=512, pair_cap=8192, ctx_items_cap=48,
                       ctx0_items_cap=64, block_bytes=8192)),
    "wide_rows": Case(
        [_wide_rows()],
        params=X3Params(max_match_count=15, window=32),
        caps=CodecCaps(dict_cap=384, pair_cap=2048, ctx_items_cap=1024,
                       ctx0_items_cap=512, block_bytes=1024),
        promoted=True),
    "veto_factor2": Case(
        [(GOLDEN / "c_source.bin").read_bytes()[:3000]],
        params=X3Params(max_match_count=8, window=1024, magic_factor2=2),
        caps=dataclasses.replace(CAPS, block_bytes=4096)),
    "sharded_mesh": Case(
        _mixed_blocks() + [b"mesh lane %d " % i * 30 for i in range(6)],
        caps=dataclasses.replace(CAPS, dict_cap=512, pair_cap=1024),
        mesh_devices=8),
}


@pytest.mark.parametrize("name", list(CASES))
def test_product_path_matches_oracle(name):
    case = CASES[name]
    mesh = (meshmod.make_mesh(case.mesh_devices) if case.mesh_devices
            else None)
    seeds = host_seeds = None
    if case.seeds is not None:
        seeds = runtime.seeds_to_arrays(case.seeds)
        host_seeds = tuple(np.asarray(a) for a in seeds)
    if case.promoted:
        for b in case.blocks:
            m = host.measure_state(b, case.params,
                                   small_cap=case.caps.ctx_small_cap)
            assert m["ctx1_promoted"] + m["ctx0_promoted"] > 0, m

    enc = runtime.encode_wave(case.blocks, case.params, case.caps, mesh,
                              seeds=seeds)
    for i, b in enumerate(case.blocks):
        want = (spec.encode(b, case.params) if seeds is None
                else host.encode(b, case.params, seeds=host_seeds))
        assert enc.payloads[i] == want, f"block {i} ({len(b)}B)"

    dec = runtime.decode_wave(enc.payloads, [len(b) for b in case.blocks],
                              case.params, case.caps, mesh, seeds=seeds)
    assert dec.payloads == case.blocks
    np.testing.assert_array_equal(dec.stats.events, enc.stats.events)
