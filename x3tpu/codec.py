"""The lane-batched x3 codec: fixed-shape event loops under ``lax.while_loop``.

Encoder and decoder each run one event per iteration across all L lanes
(independent blocks) in lockstep, with masked sub-loops for literal bytes
and arithmetic-coder renormalization.  All state is static-shape
(capacities from :class:`x3tpu.config.CodecCaps`); per-lane overflow flags
report any capacity that would have been exceeded so the host can re-run
with larger capacities.

Structure of one encoder iteration (compress loop, x3.c:372-434):
  probe -> window scan -> threshold sweep -> hit/miss decision ->
  mode selection by f32 product probabilities (x3.c:150-172) ->
  AC-code event + payload (+ literal bytes) -> dictionary MTF/insert ->
  context updates -> advance.

The decoder replays the identical state machine from the event stream
(x3.c:285-353); it needs no window scan and no longest-prefix probe (only
the exact-duplicate check on E_NEW), which is why decode throughput exceeds
encode throughput.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from x3tpu.config import (
    CodecCaps,
    E_CTX0,
    E_CTX1,
    E_EOF,
    E_IDX1,
    E_LAST,
    E_NEW,
    EVENT_INIT_FREQS,
    MAX_MATCH_LEN,
    X3Params,
)
from x3tpu.models import adaptive as am
from x3tpu.models import context as cm
from x3tpu.models import dictionary as dm
from x3tpu.ops import ac as acm
from x3tpu.ops import bitio
from x3tpu.ops.match import best_match_sweep, gather_window, window_counts

I32 = jnp.int32
U8 = jnp.uint8
U32 = jnp.uint32


class Overflow(NamedTuple):
    """Sticky per-lane capacity-overflow flags."""

    dict: jax.Array
    ctx0: jax.Array
    ctx1: jax.Array
    pairs: jax.Array
    out: jax.Array

    def any_flag(self) -> jax.Array:
        return self.dict | self.ctx0 | self.ctx1 | self.pairs | self.out


class EncCarry(NamedTuple):
    text: jax.Array     # u8 [L, TB]
    tlen: jax.Array     # i32 [L]
    p: jax.Array        # i32 [L]
    prev_c1: jax.Array  # i32 [L]
    c1: jax.Array       # i32 [L]
    d: dm.DictState
    ctx0: cm.CtxFamily
    ctx1: cm.CtxFamily
    pair_n: jax.Array   # i32 [L]
    ev: jax.Array       # i32 [L, 5]
    ms: jax.Array       # i32 [L, 32]
    ch: jax.Array       # i32 [L, 256]
    ix: jax.Array       # i32 [L, D]
    enc: acm.AcEnc
    sink: bitio.BitSink
    counts: jax.Array   # i32 [L, 5] event counters (stats, x3.c:42)
    sizes: jax.Array    # f32 [L, 5] estimated coded bits (stats, x3.c:43)
    pair_of: jax.Array  # bool [L]


def _init_shared(lanes: int, caps: CodecCaps, seeds=None, warm=None):
    d = dm.dict_init(lanes, caps.dict_cap)
    if seeds is not None:
        # dictionary-seed broadcast (x3tpu extension, no reference
        # counterpart): every lane starts with the same K fragments already
        # in its dictionary, tags 0..K-1 at recency ranks 0..K-1 (all seeds
        # share last_pos 0, and the reference's stable cost sort preserves
        # insertion order among ties).  Encoder and decoder must use the
        # same seeds (the container carries them).
        seed_strs, seed_lens = seeds  # u8 [K, 32], i32 [K]
        K = seed_strs.shape[0]
        iota = jnp.arange(caps.dict_cap, dtype=I32)
        d = d._replace(
            strs=d.strs.at[:, :K].set(seed_strs[None]),
            lens=d.lens.at[:, :K].set(seed_lens[None]),
            n=jnp.full((lanes,), K, I32),
            rank_of=jnp.tile(iota[None, :], (lanes, 1)),
            tag_of=jnp.tile(iota[None, :], (lanes, 1)),
        )
    ctx0 = cm.ctx_init(
        lanes, caps.dict_cap, caps.pair_cap, caps.ctx0_items_cap,
        with_pair=False, small_cap=caps.ctx_small_cap,
        promo_rows=caps.ctx0_promo_rows,
    )
    ctx1 = cm.ctx_init(
        lanes, caps.dict_cap, caps.dict_cap, caps.ctx_items_cap,
        with_pair=True, small_cap=caps.ctx_small_cap,
        promo_rows=caps.ctx_promo_rows,
    )
    ev = jnp.tile(jnp.asarray(EVENT_INIT_FREQS, I32)[None, :], (lanes, 1))
    ms = jnp.ones((lanes, MAX_MATCH_LEN), I32)
    ch = jnp.ones((lanes, 256), I32)
    ix = jnp.zeros((lanes, caps.dict_cap), I32)
    if seeds is not None:
        K = seeds[0].shape[0]
        ix = ix.at[:, :K].set(1)
    if warm is not None:
        # model warm-start (x3tpu container-v2 extension, warm.py): both
        # sides rebuild identical warm context state from the header's
        # (seeds, tape), exactly like the dictionary-seed lockstep rule
        H0 = warm["h0t"].shape[0]
        H1 = warm["h1t"].shape[0]
        ctx0 = ctx0._replace(
            hub_tags=ctx0.hub_tags.at[:, :H0].set(warm["h0t"][None]),
            hub_freqs=ctx0.hub_freqs.at[:, :H0].set(warm["h0f"][None]),
            hub_n=jnp.full((lanes,), 1, I32) * warm["h0n"],
            tags=ctx0.tags.at[:, warm["c0"]["rows"], :].set(
                warm["c0"]["t"][None]),
            freqs=ctx0.freqs.at[:, warm["c0"]["rows"], :].set(
                warm["c0"]["f"][None]),
            n=ctx0.n.at[:, warm["c0"]["rows"]].set(warm["c0"]["n"][None]),
        )
        ctx1 = ctx1._replace(
            hub_tags=ctx1.hub_tags.at[:, :H1].set(warm["h1t"][None]),
            hub_freqs=ctx1.hub_freqs.at[:, :H1].set(warm["h1f"][None]),
            hub_pair=ctx1.hub_pair.at[:, :H1].set(warm["h1p"][None]),
            hub_n=jnp.full((lanes,), 1, I32) * warm["h1n"],
            tags=ctx1.tags.at[:, warm["c1"]["rows"], :].set(
                warm["c1"]["t"][None]),
            freqs=ctx1.freqs.at[:, warm["c1"]["rows"], :].set(
                warm["c1"]["f"][None]),
            pair=ctx1.pair.at[:, warm["c1"]["rows"], :].set(
                warm["c1"]["p"][None]),
            n=ctx1.n.at[:, warm["c1"]["rows"]].set(warm["c1"]["n"][None]),
        )
    return d, ctx0, ctx1, ev, ms, ch, ix


def _bits(prob: jax.Array) -> jax.Array:
    """prob_to_bits (x3.c:52-55): f32 -log2."""
    return -jnp.log2(jnp.maximum(prob, jnp.float32(1e-38)))


def _nl(dlen: jax.Array, params: X3Params) -> jax.Array:
    """The -x length remap (x3.c:357-370), vectorized."""
    if not params.nl_remap:
        return dlen
    lut = jnp.asarray([1, 4, 6, 8], I32)
    return jnp.where(dlen <= 4, lut[jnp.clip(dlen - 1, 0, 3)], 9999)


def _hit_mode_stats(carry: EncCarry, tag: jax.Array, rank: jax.Array):
    """Resolve contexts and pick the cheapest coding mode for a dictionary
    hit by f32 product probability (x3.c:139-172).  Returns everything the
    coding step needs."""
    lanes = tag.shape[0]
    # pair (prev_c1, c1) -> ctx0 id; unknown -> 0 (x3.c:141-145)
    v_pair = cm.ctx_view(carry.ctx1, carry.prev_c1)
    pair_found, _, pair_id = cm.ctx_find(carry.ctx1, v_pair, carry.c1)
    cid0 = jnp.where(pair_found, pair_id, 0)

    v0 = cm.ctx_view(carry.ctx0, cid0)
    f0, pos0, _ = cm.ctx_find(carry.ctx0, v0, tag)
    low0, span0, tot0 = cm.ctx_encode_stats(carry.ctx0, v0, pos0)

    v1 = cm.ctx_view(carry.ctx1, carry.c1)
    f1, pos1, _ = cm.ctx_find(carry.ctx1, v1, tag)
    low1, span1, tot1 = cm.ctx_encode_stats(carry.ctx1, v1, pos1)

    ixlow, ixspan, ixtot = am.model_encode_stats(carry.ix, rank)

    ev_tot = jnp.sum(carry.ev, axis=1)
    p_ev0 = am.f32_prob(carry.ev[:, E_CTX0], ev_tot)
    p_ev1 = am.f32_prob(carry.ev[:, E_CTX1], ev_tot)
    p_ev2 = am.f32_prob(carry.ev[:, E_IDX1], ev_tot)

    zero = jnp.float32(0)
    prob0 = jnp.where(f0, p_ev0 * am.f32_prob(span0, jnp.maximum(tot0, 1)), zero)
    prob1 = jnp.where(f1, p_ev1 * am.f32_prob(span1, jnp.maximum(tot1, 1)), zero)
    probx = p_ev2 * am.f32_prob(ixspan, jnp.maximum(ixtot, 1))

    # strict-greater chain, IDX1 -> CTX0 -> CTX1 (x3.c:162-172)
    mode = jnp.full((lanes,), E_IDX1, I32)
    best = probx
    take0 = prob0 > best
    mode = jnp.where(take0, E_CTX0, mode)
    best = jnp.where(take0, prob0, best)
    take1 = prob1 > best
    mode = jnp.where(take1, E_CTX1, mode)

    best = jnp.where(take1, prob1, best)

    return dict(
        mode=mode, best_prob=best,
        v0=v0, f0=f0, pos0=pos0, low0=low0, span0=span0, tot0=tot0,
        v1=v1, f1=f1, pos1=pos1, low1=low1, span1=span1, tot1=tot1,
        ixlow=ixlow, ixspan=ixspan, ixtot=ixtot,
    )


def _literal_encode_loop(carry, miss, mlen, frag32=None):
    """AC-code the fragment bytes through the 256-symbol char model
    (x3.c:263-267).

    The model's within-fragment evolution is precomputed in closed form:
    byte k's interval is the base interval plus pairwise counts of earlier
    equal/smaller bytes in the same fragment (each coded byte adds 1 to its
    own frequency), so the masked sub-loop runs only bare AC steps and the
    frequency table is updated once with a histogram."""
    lanes = miss.shape[0]
    lane = jnp.arange(lanes, dtype=I32)
    W = MAX_MATCH_LEN

    frag = (
        frag32 if frag32 is not None
        else gather_window(carry.text, carry.p, W)
    ).astype(I32)                                                # [L, 32]
    cum = jnp.cumsum(carry.ch, axis=1) - carry.ch                # excl prefix
    # one-hot select instead of take_along_axis: a broadcast compare +
    # reduce over the 256-symbol table, no elementwise gather
    onehot = frag[:, :, None] == jax.lax.broadcasted_iota(I32, (1, 1, 256), 2)
    base_low = jnp.sum(jnp.where(onehot, cum[:, None, :], 0), axis=2)
    base_span = jnp.sum(jnp.where(onehot, carry.ch[:, None, :], 0), axis=2)
    base_total = jnp.sum(carry.ch, axis=1)                       # [L]

    bj = frag[:, :, None]                                        # earlier j
    bk = frag[:, None, :]                                        # current k
    jlt = (
        jax.lax.broadcasted_iota(I32, (1, W, W), 1)
        < jax.lax.broadcasted_iota(I32, (1, W, W), 2)
    )
    low_k = base_low + jnp.sum(jnp.where(jlt & (bj < bk), 1, 0), axis=1)
    span_k = base_span + jnp.sum(jnp.where(jlt & (bj == bk), 1, 0), axis=1)
    tot_k = base_total[:, None] + jax.lax.broadcasted_iota(I32, (1, W), 1)

    kiota = jax.lax.broadcasted_iota(I32, (1, W), 1)
    inmask = miss[:, None] & (kiota < mlen[:, None])

    def cond(c):
        k = c[0]
        return jnp.any(miss & (k < mlen))

    def body(c):
        k, enc, sink = c
        act = miss & (k < mlen)
        low = low_k[lane, k]
        span = span_k[lane, k]
        tot = tot_k[lane, k]
        enc, sink = acm.ac_encode(enc, sink, low, low + span, tot, act)
        return k + 1, enc, sink

    _, enc, sink = jax.lax.while_loop(
        cond, body, (jnp.zeros((), I32), carry.enc, carry.sink)
    )

    # one-shot frequency update: += histogram of the coded bytes
    sym_iota = jax.lax.broadcasted_iota(I32, (1, 1, 256), 2)
    hist = jnp.sum(
        jnp.where(inmask[:, :, None] & (frag[:, :, None] == sym_iota), 1, 0),
        axis=1,
    )
    ch = carry.ch + hist

    nbits = jnp.sum(
        jnp.where(
            inmask,
            _bits(span_k.astype(jnp.float32) / tot_k.astype(jnp.float32)),
            0.0,
        ),
        axis=1,
    )
    return ch, enc, sink, nbits


def _enc_body(carry: EncCarry, params: X3Params) -> EncCarry:
    lanes = carry.p.shape[0]
    lane = jnp.arange(lanes, dtype=I32)
    active = carry.p < carry.tlen

    # one per-lane window fetch per event feeds everything: probe target,
    # window scan, veto targets and literal bytes, fetched as unrolled
    # contiguous dynamic slices rather than an elementwise gather.
    W = max(params.window, MAX_MATCH_LEN)
    Wbuf = ((max(W, 2 * MAX_MATCH_LEN) + MAX_MATCH_LEN + 127) // 128) * 128
    win = gather_window(carry.text, carry.p, Wbuf)
    t32 = win[:, :MAX_MATCH_LEN]

    # (1) dictionary probe at p (x3.c:381)
    found, slot, dlen, matchlen = dm.dict_probe(carry.d, t32)

    # (2) forward-window probe (x3.c:383 -> backend.c:56)
    counts = window_counts(win, params.window)
    fbm = best_match_sweep(counts, win, carry.d, active, params)

    # (3) selection (x3.c:381-383)
    hit = (
        active & found & (_nl(dlen, params) >= fbm)
        & (carry.p + dlen <= carry.tlen)
    )
    miss = active & ~hit
    mlen = jnp.clip(
        jnp.minimum(fbm, carry.tlen - carry.p), 1, MAX_MATCH_LEN
    )
    dup = dm.dict_has_exact(carry.d, matchlen, mlen)

    tag = slot
    rank = carry.d.rank_of[lane, tag]

    st = _hit_mode_stats(carry, tag, rank)
    mode = st["mode"]

    # (4) event symbol
    esym = jnp.where(hit, mode, E_NEW)
    elow, espan, etot = am.model_encode_stats(carry.ev, esym)
    enc, sink = acm.ac_encode(
        carry.enc, carry.sink, elow, elow + espan, etot, active
    )
    ev = am.model_inc(carry.ev, esym, active)
    counts_arr = carry.counts.at[lane, esym].add(jnp.where(active, 1, 0))

    # (5) payload symbol: ctx0 item | ctx1 item | recency rank | length-1
    is0 = hit & (mode == E_CTX0)
    is1 = hit & (mode == E_CTX1)
    isx = hit & (mode == E_IDX1)
    mslow, msspan, mstot = am.model_encode_stats(carry.ms, mlen - 1)
    plow = jnp.where(is0, st["low0"], jnp.where(is1, st["low1"],
           jnp.where(isx, st["ixlow"], mslow)))
    pspan = jnp.where(is0, st["span0"], jnp.where(is1, st["span1"],
            jnp.where(isx, st["ixspan"], msspan)))
    ptot = jnp.where(is0, st["tot0"], jnp.where(is1, st["tot1"],
           jnp.where(isx, st["ixtot"], mstot)))
    enc, sink = acm.ac_encode(enc, sink, plow, plow + pspan, ptot, active)
    ix = am.model_inc(carry.ix, rank, isx)
    ms = am.model_inc(carry.ms, mlen - 1, miss)

    # (6) literal bytes (miss lanes)
    ch, enc, sink, lit_bits = _literal_encode_loop(
        carry._replace(enc=enc, sink=sink), miss, mlen, frag32=t32
    )

    # stats: hit events log the product probability once (x3.c:192-193);
    # E_NEW logs event + length + byte bits separately (x3.c:253-264)
    ev_bits = _bits(am.f32_prob(espan, etot))
    ms_bits = _bits(am.f32_prob(msspan, mstot))
    hit_bits = _bits(st["best_prob"])
    sizes = carry.sizes.at[lane, esym].add(
        jnp.where(hit, hit_bits, jnp.where(miss, ev_bits + ms_bits + lit_bits, 0.0))
    )

    # (7) dictionary update: MTF on hit; insert on miss unless duplicate
    ins = miss & ~dup
    ix = ix.at[lane, jnp.where(ins, carry.d.n, ix.shape[1])].set(1, mode="drop")
    d = dm.dict_mtf(carry.d, tag, hit)
    d, _ = dm.dict_insert(d, t32, mlen, ins)

    # (8) context updates + pair registration (hit lanes, x3.c:195-222)
    ctx0 = cm.ctx_update(carry.ctx0, st["v0"], tag, st["f0"], st["pos0"], hit)
    ctx1 = cm.ctx_update(
        carry.ctx1, st["v1"], tag, st["f1"], st["pos1"], hit,
        new_pair_id=carry.pair_n,
    )
    new_pair = hit & ~st["f1"]
    # pair ids run 0..S (0 = hub, i>0 = small row i-1, S = pool_rows).
    # Flag when the id about to be assigned is the last representable one:
    # one early, so a clamped row index (context.py:104) can never alias a
    # live context before the sticky flag is set.
    pair_of = carry.pair_of | (new_pair & (carry.pair_n >= carry.ctx0.tags.shape[1]))
    pair_n = carry.pair_n + jnp.where(new_pair, 1, 0).astype(I32)

    # (9) advance
    prev_c1 = jnp.where(hit, carry.c1, jnp.where(miss, 0, carry.prev_c1))
    c1 = jnp.where(hit, tag, jnp.where(miss, 0, carry.c1))
    p = carry.p + jnp.where(hit, dlen, jnp.where(miss, mlen, 0))

    return EncCarry(
        carry.text, carry.tlen, p, prev_c1, c1, d, ctx0, ctx1, pair_n,
        ev, ms, ch, ix, enc, sink, counts_arr, sizes, pair_of,
    )


def enc_init_carry(
    text: jax.Array, tlen: jax.Array, params: X3Params, caps: CodecCaps,
    seeds=None, warm=None,
) -> EncCarry:
    """Initial encoder carry for L blocks.  ``text`` u8 [L, TB] must be
    zero-padded with at least max(window, 32) bytes past each block's
    length (x3.c:579/590)."""
    lanes = text.shape[0]
    d, ctx0, ctx1, ev, ms, ch, ix = _init_shared(lanes, caps, seeds, warm)
    pair_n0 = jnp.zeros((lanes,), I32)
    if warm is not None:
        pair_n0 = pair_n0 + warm["pair_n"]
    return EncCarry(
        text=text,
        tlen=tlen.astype(I32),
        p=jnp.zeros((lanes,), I32),
        prev_c1=jnp.zeros((lanes,), I32),
        c1=jnp.zeros((lanes,), I32),
        d=d, ctx0=ctx0, ctx1=ctx1,
        pair_n=pair_n0,
        ev=ev, ms=ms, ch=ch, ix=ix,
        enc=acm.enc_init(lanes),
        sink=bitio.sink_init(lanes, caps.out_words),
        counts=jnp.zeros((lanes, E_LAST), I32),
        sizes=jnp.zeros((lanes, E_LAST), jnp.float32),
        pair_of=jnp.zeros((lanes,), jnp.bool_),
    )


def enc_active(carry: EncCarry) -> jax.Array:
    """Scalar: any lane still encoding."""
    return jnp.any(carry.p < carry.tlen)


def enc_chunk(carry: EncCarry, params: X3Params, nsteps: int) -> EncCarry:
    """Run up to ``nsteps`` events (one bounded device program; the host
    loops chunks with donated carries)."""

    def cond(c):
        i, carry = c
        return (i < nsteps) & enc_active(carry)

    def body(c):
        i, carry = c
        return i + 1, _enc_body(carry, params)

    _, carry = jax.lax.while_loop(cond, body, (jnp.zeros((), I32), carry))
    return carry


def enc_finalize(carry: EncCarry):
    """EOF + flush (x3.c:432-433, x3.c:603); returns
    (words, byte_lens, counts, sizes, overflow)."""
    lanes = carry.p.shape[0]
    every = jnp.ones((lanes,), jnp.bool_)
    eofsym = jnp.full((lanes,), E_EOF, I32)
    elow, espan, etot = am.model_encode_stats(carry.ev, eofsym)
    enc, sink = acm.ac_encode(carry.enc, carry.sink, elow, elow + espan, etot, every)
    sink = acm.ac_flush(enc, sink, every)

    overflow = Overflow(
        dict=carry.d.overflow,
        ctx0=carry.ctx0.overflow,
        ctx1=carry.ctx1.overflow,
        pairs=carry.pair_of,
        out=sink.overflow,
    )
    return sink.words, bitio.sink_byte_len(sink), carry.counts, carry.sizes, overflow


def encode_lanes(
    text: jax.Array, tlen: jax.Array, params: X3Params, caps: CodecCaps,
    seeds=None,
):
    """Whole-loop compress of L independent blocks (un-jitted core; wrap in
    jit or shard_map).  For long inputs prefer the chunked host driver
    (:func:`encode_blocks_chunked`), which bounds single-program device
    time."""
    carry = enc_init_carry(text, tlen, params, caps, seeds)
    carry = jax.lax.while_loop(
        enc_active, lambda c: _enc_body(c, params), carry
    )
    return enc_finalize(carry)


encode_blocks_jit = jax.jit(encode_lanes, static_argnames=("params", "caps"))

_enc_init_jit = jax.jit(enc_init_carry, static_argnames=("params", "caps"))
_enc_chunk_jit = jax.jit(
    enc_chunk, static_argnames=("params", "nsteps"), donate_argnums=(0,)
)
_enc_active_jit = jax.jit(enc_active)
_enc_finalize_jit = jax.jit(enc_finalize)


def encode_blocks_chunked(
    text, tlen, params: X3Params, caps: CodecCaps, seeds=None,
    chunk_steps: int = 8192, warm=None,
):
    """Host-driven chunked encode: repeated bounded device programs with a
    donated carry.  Each chunk ends at a progress point, where the host
    reads one flag to learn whether any lane is still encoding."""
    carry = _enc_init_jit(text, tlen, params, caps, seeds, warm)
    while bool(_enc_active_jit(carry)):
        carry = _enc_chunk_jit(carry, params, chunk_steps)
    return _enc_finalize_jit(carry)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


class DecCarry(NamedTuple):
    out: jax.Array      # u8 [L, OB]
    opos: jax.Array     # i32 [L]
    done: jax.Array     # bool [L]
    prev_c1: jax.Array
    c1: jax.Array
    d: dm.DictState
    ctx0: cm.CtxFamily
    ctx1: cm.CtxFamily
    pair_n: jax.Array
    ev: jax.Array
    ms: jax.Array
    ch: jax.Array
    ix: jax.Array
    dec: acm.AcDec
    src: bitio.BitSource
    counts: jax.Array
    sizes: jax.Array
    pair_of: jax.Array
    out_of: jax.Array   # bool [L]


def _scatter_bytes(
    out: jax.Array, opos: jax.Array, data: jax.Array, length: jax.Array,
    active: jax.Array,
) -> jax.Array:
    """out[l, opos[l]+j] = data[l, j] for j < length[l], masked by lane.

    Indices are left unclipped and out-of-bounds writes dropped: clipping
    would alias several j onto the last slot and a masked no-op write could
    then clobber a real byte at the buffer edge (scatter duplicate order is
    unspecified)."""
    lanes, width = data.shape
    OB = out.shape[1]
    j = jnp.arange(width, dtype=I32)[None, :]
    mask = active[:, None] & (j < length[:, None])
    idx = jnp.where(mask, opos[:, None] + j, OB)  # OB = dropped
    lane = jnp.arange(lanes, dtype=I32)[:, None]
    safe_idx = jnp.minimum(idx, OB - 1)
    cur = out[lane, safe_idx]
    return out.at[lane, idx].set(jnp.where(mask, data, cur), mode="drop")


def _literal_decode_loop(carry: DecCarry, is_new: jax.Array, length: jax.Array):
    """Decode fragment bytes; returns (frag u8 [L, 32], ch, dec, src)."""
    lanes = is_new.shape[0]

    def cond(c):
        k = c[0]
        return jnp.any(is_new & (k < length))

    def body(c):
        k, frag, ch, dec, src, nbits = c
        act = is_new & (k < length)
        tot = jnp.sum(ch, axis=1)
        step, value = acm.ac_decode_value(dec, tot)
        sym, low, span = am.model_decode_sym(ch, value)
        dec, src = acm.ac_decode_update(dec, src, step, low, low + span, act)
        ch = am.model_inc(ch, sym, act)
        nbits = nbits + jnp.where(act, _bits(am.f32_prob(span, tot)), 0.0)
        lane = jnp.arange(lanes, dtype=I32)
        kidx = jnp.where(act, jnp.minimum(k, MAX_MATCH_LEN - 1), MAX_MATCH_LEN)
        frag = frag.at[lane, kidx].set(sym.astype(U8), mode="drop")
        return k + 1, frag, ch, dec, src, nbits

    k0 = jnp.zeros((), I32)
    frag0 = jnp.zeros((lanes, MAX_MATCH_LEN), U8)
    _, frag, ch, dec, src, nbits = jax.lax.while_loop(
        cond, body,
        (k0, frag0, carry.ch, carry.dec, carry.src,
         jnp.zeros((lanes,), jnp.float32)),
    )
    return frag, ch, dec, src, nbits


def _dec_body(carry: DecCarry, params: X3Params) -> DecCarry:
    lanes = carry.opos.shape[0]
    lane = jnp.arange(lanes, dtype=I32)
    active = ~carry.done

    # (1) event symbol (x3.c:293)
    etot = jnp.sum(carry.ev, axis=1)
    step, value = acm.ac_decode_value(carry.dec, etot)
    esym, elow, espan = am.model_decode_sym(carry.ev, value)
    esym = jnp.where(active, esym, E_EOF)
    dec, src = acm.ac_decode_update(
        carry.dec, carry.src, step, elow, elow + espan, active
    )
    ev = am.model_inc(carry.ev, esym, active)
    # the reference never counts E_EOF in events[] (x3.c bumps it only in
    # decode_tag and the E_NEW branches), so decode counts match encode's
    counts_arr = carry.counts.at[lane, esym].add(
        jnp.where(active & (esym != E_EOF), 1, 0)
    )

    eof = active & (esym == E_EOF)
    is_new = active & (esym == E_NEW)
    hit = active & ~eof & ~is_new

    # (2) E_NEW: length (x3.c:274)
    mstot = jnp.sum(carry.ms, axis=1)
    step, value = acm.ac_decode_value(dec, mstot)
    lsym, lslow, lsspan = am.model_decode_sym(carry.ms, value)
    dec, src = acm.ac_decode_update(dec, src, step, lslow, lslow + lsspan, is_new)
    ms = am.model_inc(carry.ms, lsym, is_new)
    length_new = lsym + 1

    # (3) E_NEW: fragment bytes
    frag, ch, dec, src, lit_bits = _literal_decode_loop(
        carry._replace(dec=dec, src=src), is_new, length_new
    )

    # (4) hit: resolve contexts, decode payload by mode (x3.c:57-129)
    v_pair = cm.ctx_view(carry.ctx1, carry.prev_c1)
    pair_found, _, pair_id = cm.ctx_find(carry.ctx1, v_pair, carry.c1)
    cid0 = jnp.where(pair_found, pair_id, 0)
    v0 = cm.ctx_view(carry.ctx0, cid0)
    v1 = cm.ctx_view(carry.ctx1, carry.c1)

    is0 = hit & (esym == E_CTX0)
    is1 = hit & (esym == E_CTX1)
    isx = hit & (esym == E_IDX1)

    # totals differ per mode; one shared AC step
    _, _, tot0 = cm.ctx_encode_stats(carry.ctx0, v0, jnp.zeros((lanes,), I32))
    _, _, tot1 = cm.ctx_encode_stats(carry.ctx1, v1, jnp.zeros((lanes,), I32))
    ixtot = jnp.sum(carry.ix, axis=1)
    ptot = jnp.where(is0, tot0, jnp.where(is1, tot1, ixtot))
    step, value = acm.ac_decode_value(dec, jnp.maximum(ptot, 1))
    pos0d, tag0d, low0d, span0d = cm.ctx_decode_pos(carry.ctx0, v0, value)
    pos1d, tag1d, low1d, span1d = cm.ctx_decode_pos(carry.ctx1, v1, value)
    rankd, ixlowd, ixspand = am.model_decode_sym(carry.ix, value)

    tag_hit = jnp.where(is0, tag0d, jnp.where(is1, tag1d,
              carry.d.tag_of[lane, jnp.minimum(rankd, carry.d.tag_of.shape[1] - 1)]))
    plow = jnp.where(is0, low0d, jnp.where(is1, low1d, ixlowd))
    pspan = jnp.where(is0, span0d, jnp.where(is1, span1d, ixspand))
    dec, src = acm.ac_decode_update(dec, src, step, plow, plow + pspan, hit)
    ix = am.model_inc(carry.ix, rankd, isx)

    # stats mirror (x3.c:294, x3.c:78-96, x3.c:275-281)
    ev_bits = _bits(am.f32_prob(espan, etot))
    ms_bits = _bits(am.f32_prob(lsspan, mstot))
    pay_bits = _bits(am.f32_prob(pspan, jnp.maximum(ptot, 1)))
    sizes = carry.sizes.at[lane, esym].add(
        jnp.where(hit, ev_bits + pay_bits,
                  jnp.where(is_new, ev_bits + ms_bits + lit_bits,
                            jnp.where(eof, ev_bits, 0.0)))
    )

    # (5) context updates for hits (decode mirror, x3.c:99-127)
    f0u, pos0u, _ = cm.ctx_find(carry.ctx0, v0, tag_hit)
    f1u, pos1u, _ = cm.ctx_find(carry.ctx1, v1, tag_hit)
    ctx0 = cm.ctx_update(carry.ctx0, v0, tag_hit, f0u, pos0u, hit)
    ctx1 = cm.ctx_update(
        carry.ctx1, v1, tag_hit, f1u, pos1u, hit, new_pair_id=carry.pair_n
    )
    new_pair = hit & ~f1u
    # same one-early boundary as the encoder (see _enc_body step 8)
    pair_of = carry.pair_of | (new_pair & (carry.pair_n >= carry.ctx0.tags.shape[1]))
    pair_n = carry.pair_n + jnp.where(new_pair, 1, 0).astype(I32)

    # (6) dictionary + output
    # E_NEW: insert unless exact duplicate (x3.c:309-317)
    _, _, _, matchlen = dm.dict_probe(carry.d, frag)
    dup = dm.dict_has_exact(carry.d, matchlen, length_new)
    ins = is_new & ~dup
    ix = ix.at[lane, jnp.where(ins, carry.d.n, ix.shape[1])].set(1, mode="drop")
    d = dm.dict_mtf(carry.d, tag_hit, hit)
    d, _ = dm.dict_insert(d, frag, length_new, ins)

    hlen = carry.d.lens[lane, jnp.minimum(tag_hit, carry.d.lens.shape[1] - 1)]
    hstr = carry.d.strs[lane, jnp.minimum(tag_hit, carry.d.strs.shape[1] - 1)]
    length = jnp.where(is_new, length_new, hlen)
    data = jnp.where(is_new[:, None], frag, hstr)
    emit = is_new | hit
    out_of = carry.out_of | (emit & (carry.opos + length > carry.out.shape[1]))
    ok_emit = emit & ~out_of
    out = _scatter_bytes(carry.out, carry.opos, data, length, ok_emit)
    opos = carry.opos + jnp.where(ok_emit, length, 0)

    prev_c1 = jnp.where(hit, carry.c1, jnp.where(is_new, 0, carry.prev_c1))
    c1 = jnp.where(hit, tag_hit, jnp.where(is_new, 0, carry.c1))
    done = carry.done | eof | out_of

    return DecCarry(
        out, opos, done, prev_c1, c1, d, ctx0, ctx1, pair_n,
        ev, ms, ch, ix, dec, src, counts_arr, sizes, pair_of, out_of,
    )


def dec_init_carry(
    words: jax.Array, byte_lens: jax.Array, params: X3Params, caps: CodecCaps,
    seeds=None, warm=None,
) -> DecCarry:
    lanes = words.shape[0]
    d, ctx0, ctx1, ev, ms, ch, ix = _init_shared(lanes, caps, seeds, warm)
    src = bitio.source_init(words, byte_lens)
    dec, src = acm.dec_init(src, lanes)
    pair_n0 = jnp.zeros((lanes,), I32)
    if warm is not None:
        pair_n0 = pair_n0 + warm["pair_n"]
    return DecCarry(
        out=jnp.zeros((lanes, caps.block_bytes), U8),
        opos=jnp.zeros((lanes,), I32),
        done=jnp.zeros((lanes,), jnp.bool_),
        prev_c1=jnp.zeros((lanes,), I32),
        c1=jnp.zeros((lanes,), I32),
        d=d, ctx0=ctx0, ctx1=ctx1,
        pair_n=pair_n0,
        ev=ev, ms=ms, ch=ch, ix=ix,
        dec=dec, src=src,
        counts=jnp.zeros((lanes, E_LAST), I32),
        sizes=jnp.zeros((lanes, E_LAST), jnp.float32),
        pair_of=jnp.zeros((lanes,), jnp.bool_),
        out_of=jnp.zeros((lanes,), jnp.bool_),
    )


def dec_active(carry: DecCarry) -> jax.Array:
    return jnp.any(~carry.done)


def dec_chunk(carry: DecCarry, params: X3Params, nsteps: int) -> DecCarry:
    def cond(c):
        i, carry = c
        return (i < nsteps) & dec_active(carry)

    def body(c):
        i, carry = c
        return i + 1, _dec_body(carry, params)

    _, carry = jax.lax.while_loop(cond, body, (jnp.zeros((), I32), carry))
    return carry


def dec_finalize(carry: DecCarry):
    overflow = Overflow(
        dict=carry.d.overflow,
        ctx0=carry.ctx0.overflow,
        ctx1=carry.ctx1.overflow,
        pairs=carry.pair_of,
        out=carry.out_of,
    )
    return carry.out, carry.opos, carry.counts, carry.sizes, overflow


def decode_lanes(
    words: jax.Array, byte_lens: jax.Array, params: X3Params, caps: CodecCaps,
    seeds=None,
):
    """Whole-loop decompress of L independent streams (words u32 [L, IW]).

    Returns (out u8 [L, OB], out_lens i32 [L], counts [L, 5],
    sizes f32 [L, 5], overflow)."""
    carry = dec_init_carry(words, byte_lens, params, caps, seeds)
    carry = jax.lax.while_loop(
        dec_active, lambda c: _dec_body(c, params), carry
    )
    return dec_finalize(carry)


decode_blocks_jit = jax.jit(decode_lanes, static_argnames=("params", "caps"))

_dec_init_jit = jax.jit(dec_init_carry, static_argnames=("params", "caps"))
_dec_chunk_jit = jax.jit(
    dec_chunk, static_argnames=("params", "nsteps"), donate_argnums=(0,)
)
_dec_active_jit = jax.jit(dec_active)
_dec_finalize_jit = jax.jit(dec_finalize)


def decode_blocks_chunked(
    words, byte_lens, params: X3Params, caps: CodecCaps, seeds=None,
    chunk_steps: int = 8192, warm=None,
):
    """Host-driven chunked decode (see encode_blocks_chunked)."""
    carry = _dec_init_jit(words, byte_lens, params, caps, seeds, warm)
    while bool(_dec_active_jit(carry)):
        carry = _dec_chunk_jit(carry, params, chunk_steps)
    return _dec_finalize_jit(carry)


# ---------------------------------------------------------------------------
# Host wrappers
# ---------------------------------------------------------------------------


class X3CapacityError(RuntimeError):
    """A static capacity was exceeded; re-run with larger CodecCaps."""

    def __init__(self, flags: dict):
        self.flags = flags
        super().__init__(f"codec capacity overflow: {flags}")


def _check_overflow(overflow: Overflow) -> None:
    flags = {
        name: np.asarray(getattr(overflow, name))
        for name in ("dict", "ctx0", "ctx1", "pairs", "out")
    }
    bad = {k: v.nonzero()[0].tolist() for k, v in flags.items() if v.any()}
    if bad:
        raise X3CapacityError(bad)


def pack_blocks(
    blocks: Sequence[bytes], params: X3Params, caps: CodecCaps
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad blocks into the [L, TB] text buffer (+window zero padding,
    x3.c:579/590)."""
    # pad covers the event loop's window fetch (Wbuf bytes past any
    # position, rounded up to 1 KiB) plus the trailing probe bytes
    wbuf = ((max(params.window, 2 * MAX_MATCH_LEN) + MAX_MATCH_LEN + 127)
            // 128) * 128
    pad = ((wbuf + 1023) // 1024) * 1024 + 64
    TB = caps.block_bytes + pad
    text = np.zeros((len(blocks), TB), np.uint8)
    tlen = np.zeros((len(blocks),), np.int32)
    for i, b in enumerate(blocks):
        if len(b) > caps.block_bytes:
            raise ValueError(f"block {i} larger than caps.block_bytes")
        text[i, : len(b)] = np.frombuffer(b, np.uint8)
        tlen[i] = len(b)
    return text, tlen


def encode_blocks(
    blocks: Sequence[bytes],
    params: X3Params = X3Params(),
    caps: CodecCaps = CodecCaps(),
    seeds=None,
) -> List[bytes]:
    """Compress a batch of independent blocks; each result is a standalone
    reference-format x3 stream."""
    text, tlen = pack_blocks(blocks, params, caps)
    words, byte_lens, _, _, overflow = encode_blocks_chunked(
        jnp.asarray(text), jnp.asarray(tlen), params, caps, seeds
    )
    _check_overflow(overflow)
    words_np = np.asarray(words)
    lens_np = np.asarray(byte_lens)
    return [
        words_np[i].astype("<u4").tobytes()[: lens_np[i]]
        for i in range(len(blocks))
    ]


def decode_blocks(
    streams: Sequence[bytes],
    params: X3Params = X3Params(),
    caps: CodecCaps = CodecCaps(),
    seeds=None,
) -> List[bytes]:
    """Decompress a batch of reference-format x3 streams."""
    iw = max(1, max((len(s) + 3) // 4 for s in streams) if streams else 1)
    words = np.zeros((len(streams), iw), np.uint32)
    byte_lens = np.zeros((len(streams),), np.int32)
    for i, s in enumerate(streams):
        pad = (-len(s)) % 4
        arr = np.frombuffer(s + b"\x00" * pad, "<u4")
        words[i, : len(arr)] = arr
        byte_lens[i] = len(s)
    out, out_lens, _, _, overflow = decode_blocks_chunked(
        jnp.asarray(words), jnp.asarray(byte_lens), params, caps, seeds
    )
    _check_overflow(overflow)
    out_np = np.asarray(out)
    lens_np = np.asarray(out_lens)
    return [out_np[i, : lens_np[i]].tobytes() for i in range(len(streams))]
