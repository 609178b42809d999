"""Warm-start tape + replay unit tests (container v2; x3tpu/warm.py).

This file pins the format and the replay rule, and the lockstep of the
native host codec and the XLA codec under it.
"""

import pytest

from x3tpu import warm


def test_tape_roundtrip_and_reset_collapse():
    tape = [warm.RESET, 3, 1, warm.RESET, warm.RESET, 2, 2, warm.RESET]
    enc = warm.encode_tape(tape)
    got, off = warm.decode_tape(enc)
    assert off == len(enc)
    # leading/trailing resets dropped, runs collapsed
    assert got == [3, 1, warm.RESET, 2, 2]


def test_tape_truncation_raises():
    enc = warm.encode_tape([1, 2, 3])
    with pytest.raises(ValueError):
        warm.decode_tape(enc[:-1])
    with pytest.raises(ValueError):
        warm.decode_tape(b"\xff\xff\xff\xff")


def test_replay_mirrors_update_contexts():
    # chain 5 -> 7 -> 5, then a reset, then 7 -> 5 again
    tape = [5, 7, 5, warm.RESET, 7, 5]
    w = warm.replay(tape, num_seeds=8)
    # event 1: (prev=0, c1=0) fallback ctx0[0] += tag5; ctx1[0] += 5;
    #   pair (0,5) registered (id 0)
    # event 2: (0,5) -> cid 0; ctx0[0] += 7; ctx1[5] += 7; pair (5,7)=id1
    # event 3: (5,7) -> cid 1; ctx0[1] += 5; ctx1[7] += 5; pair (7,5)=id2
    # reset; event 4: fallback += 7; ctx1[0] += 7; pair (0,7)=id3
    # event 5: (0,7) -> cid 3; ctx0[3] += 5; ctx1[7] += 5; (7,5) known
    assert w.pairs == [(0, 5), (5, 7), (7, 5), (0, 7)]
    assert w.ctx0[0] == [(5, 1), (7, 2)]
    assert w.ctx0[1] == [(5, 1)]
    assert w.ctx0[2] == []
    assert w.ctx0[3] == [(5, 1)]
    assert w.ctx1[0] == [(5, 1), (7, 1)]
    assert w.ctx1[5] == [(7, 1)]
    assert w.ctx1[7] == [(5, 2)]


def test_replay_caps_and_validation():
    # non-hub rows cap at ROW_CAP items; hub at HUB_CAP
    n = warm.ROW_CAP + 5
    tape = []
    for t in range(1, n + 1):
        tape += [1, t]  # each pair (1, t) bumps ctx1[1]
    w = warm.replay(tape, num_seeds=n + 2)
    assert len(w.ctx1[1]) == warm.ROW_CAP
    with pytest.raises(ValueError):
        warm.replay([99], num_seeds=10)


def test_warm_lockstep_host_xla_vm():
    """The warm replay must produce BIT-IDENTICAL streams on the native
    host codec and the XLA codec, and warm streams must decode on each —
    the same lockstep contract as dictionary seeds."""
    import numpy as np

    import jax.numpy as jnp

    from x3tpu import codec, host
    from x3tpu.config import CodecCaps, X3Params

    params = X3Params(max_match_count=4, window=512)
    sample = b"alpha beta gamma " * 120 + b"delta epsilon " * 80
    strs, lens, tape = host.train_tape(sample, params, k=64)
    tape, _ = warm.decode_tape(warm.encode_tape(tape))
    w = warm.replay(tape, len(lens))
    wa = warm.pack(w)
    assert wa.pair_n > 0 and wa.ctx1_idx  # the corpus exercises the state

    data = b"alpha beta gamma delta epsilon alpha beta gamma " * 20
    seeds = (strs, lens)
    hs = host.encode(data, params, seeds=seeds, warm_tape=tape)
    assert host.decode(hs, seeds=seeds, warm_tape=tape,
                       max_output=len(data) + 64) == data

    caps = CodecCaps(dict_cap=512, pair_cap=4096, ctx_items_cap=128,
                     ctx0_items_cap=128, ctx_small_cap=16, block_bytes=4096)
    warm.check_fits(wa, caps.dict_cap, caps.pair_cap, caps.ctx_small_cap,
                    min(caps.dict_cap, 8192))
    sj = (jnp.asarray(strs), jnp.asarray(lens))
    wx = warm.for_xla(wa, caps.ctx_small_cap)
    text, tlen = codec.pack_blocks([data], params, caps)
    ww, bl, *_ = codec.encode_blocks_chunked(text, tlen, params, caps,
                                             seeds=sj, warm=wx)
    xs = np.asarray(ww)[0].astype("<u4").tobytes()[: int(np.asarray(bl)[0])]
    assert xs == hs

    iw = (len(hs) + 3) // 4 + 2
    wsrc = np.zeros((1, iw), np.uint32)
    a = np.frombuffer(hs + b"\x00" * ((-len(hs)) % 4), "<u4")
    wsrc[0, : len(a)] = a
    lsrc = np.asarray([len(hs)], np.int32)
    out, opos, *_ = codec.decode_blocks_chunked(
        wsrc, lsrc, params, caps, seeds=sj, warm=wx)
    assert np.asarray(out)[0][: int(np.asarray(opos)[0])].tobytes() == data


def test_warm_container_roundtrip():
    """compress(warm_start=True) emits a v-flagged container that
    decompress() reproduces exactly (tape + seeds in the header)."""
    from bench import build_corpus
    from x3tpu.config import X3Params
    from x3tpu.parallel import blocks as blk
    from x3tpu.parallel import runtime

    params = X3Params(max_match_count=4, window=1024)
    data = build_corpus(64 * 1024)
    c = runtime.compress(data, params, block_bytes=16 * 1024,
                         warm_start=True)
    assert blk.is_container(c)
    _p, _l, _bb, seeds, tape = blk.unpack_container(c)
    assert seeds and tape
    assert runtime.decompress(c, params) == data
