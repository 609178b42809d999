"""Calibration of caps_for_block against measured state growth.

The capacity heuristics (parallel/runtime.py caps_for_block) size the
device codec's fixed-shape state.  These tests measure real state growth
with the native host codec (host.measure_state == an instrumented
reference encode) on two corpus classes — diverse binary (/usr/bin
executables) and the bench text corpus — and assert the heuristic
capacities cover every structure the device codec allocates: dictionary,
pair map, hub rows, per-context items, and the per-family big-row pools
that rows past the 16-item small pool are promoted into.  Auto-retry
covers tails, but the common case must not rely on it.
"""

import pathlib

import pytest

from x3tpu import host
from x3tpu.config import X3Params
from x3tpu.parallel.runtime import caps_for_block


def _usr_bin_corpus(n: int) -> bytes:
    bins = sorted(
        (p for p in pathlib.Path("/usr/bin").iterdir() if p.is_file()),
        key=lambda p: -p.stat().st_size,
    )
    blob = b"".join(p.read_bytes() for p in bins[:40])
    assert len(blob) >= n, "container /usr/bin too small for the corpus"
    return blob[:n]


def _assert_covered(m, caps, margin=0.8):
    # the codec's hub rows are sized dict_cap (codec._init_shared)
    assert m["dict"] <= caps.dict_cap, m
    assert m["ctx0_hub"] <= caps.dict_cap, m
    assert m["ctx1_hub"] <= caps.dict_cap, m
    # headroom: the heuristics should not be NEAR the cliff either
    assert m["pairs"] <= margin * caps.pair_cap, m
    assert m["ctx1_max"] <= margin * caps.ctx_items_cap, m
    assert m["ctx0_max"] <= caps.ctx0_items_cap, m
    # promotion POOLS are per-lane resources: a pool-exhausted promotion
    # raises the family overflow even when every row fits its width
    assert m["ctx1_promoted"] <= margin * caps.ctx_promo_rows, m
    assert m["ctx0_promoted"] <= margin * caps.ctx0_promo_rows, m


@pytest.mark.parametrize("mib", [1, 2, 4])
def test_caps_for_block_cover_usr_bin_corpus(mib):
    block = mib << 20
    data = _usr_bin_corpus(block)
    m = host.measure_state(data, X3Params(),
                           small_cap=caps_for_block(block).ctx_small_cap)
    _assert_covered(m, caps_for_block(block))


@pytest.mark.parametrize("kib", [64, 256])
def test_caps_for_block_cover_small_text_blocks(kib):
    """Text blocks at the smoke test's 64 KiB and at 256 KiB."""
    _check_text(kib << 10)


@pytest.mark.parametrize("mib", [8, 16])
def test_caps_for_block_cover_large_text_blocks(mib):
    """The 8-16 MiB regime (measured 16 MiB text: dict ~11.8K, pairs
    ~513K, ctx1 max ~2.8K, ctx0 promoted ~10.6K rows).  Diverse binary at
    these sizes needs a larger dictionary (38K entries at 8 MiB) and is
    served by the overflow auto-retry by design."""
    _check_text(mib << 20)


def _check_text(block):
    from bench import build_corpus

    data = build_corpus(block)
    caps = caps_for_block(block)
    m = host.measure_state(data, X3Params(), small_cap=caps.ctx_small_cap)
    _assert_covered(m, caps)
    assert m["ctx0_max"] <= 0.8 * caps.ctx0_items_cap, m
