"""Lane-parallel forward-window match finding (backend.c).

``window_counts`` turns the reference's per-position scan with early break
(backend.c:66-74) into a dense [L, S] running prefix-AND over 32 shifted
comparisons — count[i] = number of window positions repeating the first
i+1 bytes at p.

``best_match_sweep`` collapses the reference's two-level threshold sweep
(backend.c:76-97) into an argmax: candidate i triggers first at threshold
level min(count[i]-1, T), and the sweep visits (level, i) in lexicographic
descending order, so the winner is the non-vetoed candidate with maximal
(level, i).  Vetoes (the "magic factor" heuristics that prefer an upcoming
dictionary match) need the dictionary's best-match length at p+i, so they
run in a short masked loop — one batched dictionary probe per round,
usually 1-2 rounds since candidates with i < 2 cannot be vetoed when
factor2 is off.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from x3tpu.config import MAX_MATCH_LEN, X3Params
from x3tpu.models.dictionary import DictState, dict_probe_len

I32 = jnp.int32


def gather_window(text: jax.Array, p: jax.Array, width: int) -> jax.Array:
    """text[l, p[l] : p[l]+width] as [L, width] (text is pre-padded so this
    never reads out of bounds).

    Implemented as L unrolled contiguous dynamic slices: XLA lowers
    take_along_axis to an elementwise gather, one index per byte, while a
    contiguous dynamic slice copies a whole row."""
    L = text.shape[0]
    rows = [
        jax.lax.dynamic_slice(text, (l, p[l]), (1, width)) for l in range(L)
    ]
    return jnp.concatenate(rows, axis=0)


def window_counts(win: jax.Array, window: int) -> jax.Array:
    """count[i] over a pre-fetched window ``win`` [L, >=window] whose column
    0 is position p.  Scans s in [p+1, p+window-32) (backend.c:66) as a
    running prefix-AND over 32 shifted slice compares — all contiguous
    slices of the resident window (the expensive part, the per-lane dynamic
    window *fetch*, happens once per event in codec.gather_window)."""
    lanes = win.shape[0]
    S = window - MAX_MATCH_LEN - 1
    if S <= 0:
        return jnp.zeros((lanes, MAX_MATCH_LEN), I32)
    run = jnp.ones((lanes, S), jnp.bool_)
    counts = []
    for i in range(MAX_MATCH_LEN):
        run = run & (win[:, 1 + i : 1 + i + S] == win[:, i : i + 1])
        counts.append(jnp.sum(run, axis=1).astype(I32))
    return jnp.stack(counts, axis=1)


def select_window32(win: jax.Array, bi: jax.Array) -> jax.Array:
    """win[l, bi[l] : bi[l]+32] for bi in [0, 32): masked select over the
    32 static slices (avoids a per-lane dynamic gather)."""
    lanes = win.shape[0]
    out = jnp.zeros((lanes, MAX_MATCH_LEN), win.dtype)
    for i in range(MAX_MATCH_LEN):
        out = jnp.where(
            (bi == i)[:, None], win[:, i : i + MAX_MATCH_LEN], out
        )
    return out


def best_match_sweep(
    counts: jax.Array,
    win: jax.Array,
    d: DictState,
    active: jax.Array,
    params: X3Params,
) -> jax.Array:
    """The chosen new-fragment length >= 1 per lane (find_best_match,
    backend.c:56-100).  Veto-probe targets come from the resident window."""
    lanes = counts.shape[0]
    T = params.max_match_count
    if T < 1:
        return jnp.ones((lanes,), I32)

    iota = jnp.arange(MAX_MATCH_LEN, dtype=I32)[None, :]
    cand0 = counts >= 2  # count[i] > tc for some tc >= 1
    level = jnp.minimum(counts - 1, T)
    f1 = params.magic_factor1
    f2 = params.magic_factor2

    if f1 == 0 and f2 == 0:
        key = jnp.where(cand0, level * MAX_MATCH_LEN + iota, -1)
        has = jnp.any(cand0, axis=1)
        best_i = jnp.argmax(key, axis=1).astype(I32)
        return jnp.where(active & has, best_i + 1, 1)

    if f2 > 0:
        # LOOP-FREE: the veto probes vl[o] (longest dict entry prefixing
        # the window at offset o) don't depend on the candidate, and a
        # vetoed candidate is vetoed at every threshold, so the sweep is
        # exactly "argmax of (level, i) over non-vetoed candidates".
        # One batch of MML-1 probes replaces the while_loop's
        # MML-1-probes-PER-ROUND fori; f2's exists-o<=i test is a cummax of
        # vl[o]-o.
        vls = [jnp.zeros((lanes,), I32)]
        for o in range(1, MAX_MATCH_LEN):
            vls.append(dict_probe_len(
                d, win[:, o : o + MAX_MATCH_LEN]).astype(I32))
        vl = jnp.stack(vls, axis=1)  # [L, MML]
        veto = jnp.zeros((lanes, MAX_MATCH_LEN), jnp.bool_)
        if f1 > 0:
            veto = veto | ((iota >= 2) & (vl > 0) & (vl * f1 > iota + 1))
        x = jnp.where(iota >= 1, vl - iota, -(1 << 20))
        pm = jax.lax.cummax(x, axis=1)
        veto = veto | ((iota >= 1) & (pm * f2 > iota + 1))
        ok = cand0 & ~veto
        key = jnp.where(ok, level * MAX_MATCH_LEN + iota, -1)
        has = jnp.any(ok, axis=1)
        best_i = jnp.argmax(key, axis=1).astype(I32)
        return jnp.where(active & has, best_i + 1, 1)

    result0 = jnp.where(active, 0, 1).astype(I32)  # 0 = unresolved

    def cond(carry):
        result, _ = carry
        return jnp.any(result == 0)

    def body(carry):
        result, remaining = carry
        unresolved = result == 0
        key = jnp.where(remaining, level * MAX_MATCH_LEN + iota, -1)
        has = jnp.any(remaining, axis=1)
        best_i = jnp.argmax(key, axis=1).astype(I32)
        # out of candidates -> fall back to length 1 (backend.c:99)
        result = jnp.where(unresolved & ~has, 1, result)
        pending = unresolved & has

        vetoed = jnp.zeros((lanes,), jnp.bool_)
        if f1 > 0:
            tgt = select_window32(win, best_i)
            dlen = dict_probe_len(d, tgt)
            vetoed = vetoed | (
                pending
                & (best_i >= 2)
                & (dlen > 0)
                & (dlen * f1 > best_i + 1)
            )
        if f2 > 0:
            def probe_o(o, acc):
                tgt_o = jax.lax.dynamic_slice_in_dim(
                    win, o, MAX_MATCH_LEN, axis=1
                )
                dlen_o = dict_probe_len(d, tgt_o)
                hit_o = (
                    (o <= best_i)
                    & (dlen_o > 0)
                    & ((dlen_o - o) * f2 > best_i + 1)
                )
                return acc | hit_o

            veto2 = jax.lax.fori_loop(
                1, MAX_MATCH_LEN, probe_o, jnp.zeros((lanes,), jnp.bool_)
            )
            vetoed = vetoed | (pending & (best_i >= 1) & veto2)

        result = jnp.where(pending & ~vetoed, best_i + 1, result)
        lane = jnp.arange(lanes, dtype=I32)
        keep = remaining[lane, best_i] & ~vetoed
        remaining = remaining.at[lane, best_i].set(keep)
        return result, remaining

    result, _ = jax.lax.while_loop(cond, body, (result0, cand0))
    return result
