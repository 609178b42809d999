"""Model warm-start: the container-v2 tape and its replay rule.

Dictionary seeds (parallel/blocks.py) recover about half the ratio lost
to per-block state resets; the remainder is context/pair model reset
(BENCH_NOTES "Ratio at scale").  This module defines the x3tpu
extension that warms those models too: the container carries a TAPE —
the training encode's event sequence mapped to seed indices, with RESET
markers where the chain broke (an E_NEW event, or a dictionary event
whose tag was not kept as a seed) — and BOTH sides derive the warm
context state from (seeds, tape) with the replay below.  The rule is
part of the versioned container format: every implementation (spec
oracle, native host, XLA codec) must apply it identically,
exactly like the dictionary-seed lockstep rule.

The replay mirrors the real post-event update (x3.c:195-222, spec.py
CodecState.update_contexts) as if the tape's dictionary events had
happened, under fixed capacity caps chosen so the warm rows fit every
implementation's SMALLEST init tier (XLA small pool 16 items;
hubs):

  * per-row item cap ROW_CAP = 16 (both families; hub rows HUB_CAP)
  * pair registrations stop at PAIR_WARM_CAP

Design: docs/warm_start_design.md.  Ship gate: the ratio_at_scale
warm-start row must beat seeds-only by more than the tape's header
cost.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

RESET = 0xFFFF          # tape marker: context chain reset
HUB_CAP = 1024          # warm item cap for the two hub rows
ROW_CAP = 16            # warm item cap for non-hub rows (XLA small pool)
PAIR_WARM_CAP = 4096    # warm pair-registration cap
TAPE_MAX = 16384        # entries kept (head of the training sequence)


def encode_tape(entries: List[int]) -> bytes:
    """Tape -> container bytes: u32 count + LEB128 varints of (0 for
    RESET, else seed_index + 1).  Seeds are usage-RANKED, so hot indices
    are small and most entries fit one byte (~55% smaller headers than
    the u16 form on the 1 MiB proxy).  Collapses runs of RESET and drops
    leading/trailing resets (they are replay no-ops)."""
    out: List[int] = []
    for s in entries[:TAPE_MAX * 2]:
        if s == RESET and (not out or out[-1] == RESET):
            continue
        out.append(s)
    while out and out[-1] == RESET:
        out.pop()
    out = out[:TAPE_MAX]
    body = bytearray()
    for s in out:
        v = 0 if s == RESET else s + 1
        while True:
            b = v & 0x7F
            v >>= 7
            body.append(b | (0x80 if v else 0))
            if not v:
                break
    return struct.pack("<I", len(out)) + bytes(body)


def decode_tape(data: bytes, offset: int = 0) -> Tuple[List[int], int]:
    """Container bytes -> (tape, next_offset).  Raises ValueError on
    truncation (the container unpacker's error contract)."""
    if offset + 4 > len(data):
        raise ValueError("warm tape: truncated count")
    (n,) = struct.unpack_from("<I", data, offset)
    offset += 4
    if n > TAPE_MAX:
        raise ValueError(f"warm tape: count {n} exceeds TAPE_MAX")
    tape: List[int] = []
    for _ in range(n):
        v = 0
        shift = 0
        while True:
            if offset >= len(data):
                raise ValueError("warm tape: truncated entries")
            b = data[offset]
            offset += 1
            v |= (b & 0x7F) << shift
            shift += 7
            if not (b & 0x80):
                break
            if shift > 28:
                raise ValueError("warm tape: varint overflow")
        tape.append(RESET if v == 0 else v - 1)
    return tape, offset


@dataclass
class WarmState:
    """Replayed warm context state, implementation-neutral.

    ``pairs``: (t0, t1) tuples in registration order — dense id i maps
    to spec's ``ctx0[i]`` (id 0 SHARES the unknown-pair fallback table,
    matching TagPairMap.add's id assignment).
    ``ctx0``: items per ctx0 table, index-aligned with spec's ctx0 list
    (index 0 = the fallback/hub table); items are (tag, freq) in
    insertion order.
    ``ctx1``: tag -> items, same shape; tag 0 is the ctx1 hub.
    """

    pairs: List[Tuple[int, int]] = field(default_factory=list)
    ctx0: List[List[Tuple[int, int]]] = field(default_factory=lambda: [[]])
    ctx1: Dict[int, List[Tuple[int, int]]] = field(default_factory=dict)


def replay(tape: List[int], num_seeds: int) -> WarmState:
    """Derive the warm state from a tape over ``num_seeds`` seed tags.

    Deterministic and identical on encoder and decoder; out-of-range
    entries raise (a malformed container must fail loudly, not diverge).
    """
    w = WarmState()
    pair_ids: Dict[Tuple[int, int], int] = {}

    def row_cap(is_hub: bool) -> int:
        return HUB_CAP if is_hub else ROW_CAP

    def add_or_inc(items: List[Tuple[int, int]], tag: int,
                   is_hub: bool) -> None:
        for i, (t, f) in enumerate(items):
            if t == tag:
                items[i] = (t, f + 1)
                return
        if len(items) < row_cap(is_hub):
            items.append((tag, 1))

    def find(items: List[Tuple[int, int]], tag: int) -> int:
        for i, (t, _f) in enumerate(items):
            if t == tag:
                return i
        return -1

    prev, c1 = 0, 0
    for s in tape:
        if s == RESET:
            prev, c1 = 0, 0
            continue
        if not 0 <= s < num_seeds:
            raise ValueError(f"warm tape entry {s} >= seed count "
                             f"{num_seeds}")
        tag = s
        cid = pair_ids.get((prev, c1), 0)  # unknown pair -> fallback id 0
        add_or_inc(w.ctx0[cid], tag, is_hub=(cid == 0))
        # ctx1 item append and pair registration are 1:1 in the real
        # codec (x3.c:211-221: a tag is appended to ctx1[c1] exactly
        # when the (c1, tag) pair registers) — and the XLA layout
        # DEPENDS on that: pair ids live inline in the item slots.  The
        # replay preserves the invariant under caps: a new item is
        # admitted only when its pair can register too; otherwise both
        # are skipped.
        items = w.ctx1.setdefault(c1, [])
        i = find(items, tag)
        if i >= 0:
            items[i] = (tag, items[i][1] + 1)
        elif (len(items) < row_cap(c1 == 0)
              and len(pair_ids) < PAIR_WARM_CAP):
            items.append((tag, 1))
            pair_ids[(c1, tag)] = len(pair_ids)
            w.pairs.append((c1, tag))
            w.ctx0.append([])
        prev, c1 = c1, tag
    return w


# ---------------------------------------------------------------------------
# Layout packing.  ``pack`` produces SINGLE-LANE numpy arrays (every lane
# of a wave starts from the same warm state, like dictionary seeds); the
# codec/driver inits broadcast them into their own layouts.
# ---------------------------------------------------------------------------


@dataclass
class WarmArrays:
    """Implementation-neutral packed warm state.

    ``hub0/hub1``: (tags, freqs[, pairs]) i32 arrays of the two hub rows.
    ``ctx0_idx/ctx0_items``: non-hub ctx0 rows — row ``cid-1``; items as
    [n_items, 2] (tag, freq).  ``ctx1_idx/ctx1_items``: non-hub ctx1 rows
    — row ``c1-1``; items as [n_items, 3] (tag, freq, pair_id).
    ``pair_n``: registered pair count (the next dense id)."""

    hub0_tags: np.ndarray
    hub0_freqs: np.ndarray
    hub1_tags: np.ndarray
    hub1_freqs: np.ndarray
    hub1_pairs: np.ndarray
    ctx0_idx: List[int]
    ctx0_items: List[np.ndarray]
    ctx1_idx: List[int]
    ctx1_items: List[np.ndarray]
    pair_n: int


def pack(w: WarmState) -> WarmArrays:
    pid = {p: i for i, p in enumerate(w.pairs)}

    def arr2(items):
        return np.asarray([[t, f] for t, f in items], np.int32).reshape(
            -1, 2
        )

    h0 = arr2(w.ctx0[0])
    h1items = w.ctx1.get(0, [])
    h1 = np.asarray(
        [[t, f, pid[(0, t)]] for t, f in h1items], np.int32
    ).reshape(-1, 3)
    ctx0_idx, ctx0_items = [], []
    for cid in range(1, len(w.ctx0)):
        if w.ctx0[cid]:
            ctx0_idx.append(cid - 1)
            ctx0_items.append(arr2(w.ctx0[cid]))
    ctx1_idx, ctx1_items = [], []
    for c1 in sorted(w.ctx1):
        if c1 >= 1 and w.ctx1[c1]:
            ctx1_idx.append(c1 - 1)
            ctx1_items.append(np.asarray(
                [[t, f, pid[(c1, t)]] for t, f in w.ctx1[c1]], np.int32
            ).reshape(-1, 3))
    return WarmArrays(
        hub0_tags=h0[:, 0].copy(), hub0_freqs=h0[:, 1].copy(),
        hub1_tags=h1[:, 0].copy(), hub1_freqs=h1[:, 1].copy(),
        hub1_pairs=h1[:, 2].copy(),
        ctx0_idx=ctx0_idx, ctx0_items=ctx0_items,
        ctx1_idx=ctx1_idx, ctx1_items=ctx1_items,
        pair_n=len(w.pairs),
    )


def check_fits(wa: WarmArrays, dict_cap: int, pair_cap: int,
               small_cap: int, hub_cap: int) -> None:
    """Raise when a configuration cannot host the warm state — warm
    start must fail loudly, never silently diverge (the replay rule is
    config-independent; undersized configs are simply unsupported)."""
    if len(wa.hub0_tags) > hub_cap or len(wa.hub1_tags) > hub_cap:
        raise ValueError("warm state exceeds hub capacity")
    if wa.pair_n > pair_cap:
        raise ValueError("warm state exceeds pair capacity")
    if small_cap < ROW_CAP:
        raise ValueError(f"warm start needs ctx_small_cap >= {ROW_CAP}")
    if wa.ctx1_idx and max(wa.ctx1_idx) >= dict_cap - 1:
        raise ValueError("warm ctx1 row beyond dict capacity")
    if wa.ctx0_idx and max(wa.ctx0_idx) >= pair_cap:
        raise ValueError("warm ctx0 row beyond pair capacity")


def for_xla(wa: WarmArrays, small_cap: int) -> Dict[str, np.ndarray]:
    """WarmArrays -> dense single-lane arrays for the codec init
    (codec._init_shared; models/context.py CtxFamily: hub planes +
    small-pool rows).  Row
    arrays are [K, small_cap] padded with zeros; ``*_rows`` are the
    small-pool row indices to scatter into."""

    def rows(idx, items, with_pair):
        K = len(idx)
        t = np.zeros((K, small_cap), np.int32)
        f = np.zeros((K, small_cap), np.int32)
        p = np.zeros((K, small_cap), np.int32)
        n = np.zeros((K,), np.int32)
        for k, it in enumerate(items):
            m = len(it)
            assert m <= small_cap
            t[k, :m] = it[:, 0]
            f[k, :m] = it[:, 1]
            if with_pair:
                p[k, :m] = it[:, 2]
            n[k] = m
        out = {"rows": np.asarray(idx, np.int32), "t": t, "f": f, "n": n}
        if with_pair:
            out["p"] = p
        return out

    return {
        "h0t": wa.hub0_tags, "h0f": wa.hub0_freqs,
        "h0n": np.int32(len(wa.hub0_tags)),
        "h1t": wa.hub1_tags, "h1f": wa.hub1_freqs,
        "h1p": wa.hub1_pairs, "h1n": np.int32(len(wa.hub1_tags)),
        "c0": rows(wa.ctx0_idx, wa.ctx0_items, with_pair=False),
        "c1": rows(wa.ctx1_idx, wa.ctx1_items, with_pair=True),
        "pair_n": np.int32(wa.pair_n),
    }
