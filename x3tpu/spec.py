"""Executable specification of the x3 compressed-stream format.

This module is the single source of truth for the codec's *behavioral
contract*: a clear, array-oriented NumPy implementation of the exact bit
format produced/consumed by the reference ``x3`` binary
(xbarin02/x3-compressor).  Every kernel in :mod:`x3tpu.codec` is
differentially tested against this oracle, and this oracle is itself tested
bit-for-bit against the reference C binary (tests/test_vs_reference.py).

It is written from the behavioral contract in SURVEY.md §0 (not translated
from the C source); reference file:line citations mark which invariant each
piece implements.

Format summary (headerless, self-describing):

* One shared adaptive 31-bit arithmetic coder (ac.c) writes all events into
  an LSB-first little-endian u32 bit stream (bio.c).
* Events (x3.c:33-40): E_CTX0/E_CTX1/E_IDX1 code a dictionary hit (by tag in
  an order-2/order-1 context, or by recency rank in an order-0 model),
  E_NEW codes a literal fragment (length-1 then raw bytes), E_EOF ends the
  stream.
* After every event the dictionary is re-ranked by recency (dict.c:132-146).
  Because positions strictly increase and at most one entry's ``last_pos``
  changes per event, the re-sort is provably equivalent to a move-to-front
  of the touched entry — the key fact the device codec exploits.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from x3tpu.config import (
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

# Arithmetic-coder interval constants (ac.c:31-41): 31-bit range with
# quarter-scaling.
AC_TOP = 0x7FFFFFFF
AC_FIRST_QUARTER = 0x20000000
AC_HALF = 0x40000000
AC_THIRD_QUARTER = 0x60000000


# ---------------------------------------------------------------------------
# Bit I/O: LSB-first packing into little-endian uint32 words (bio.c).
# ---------------------------------------------------------------------------


class BitWriter:
    """LSB-first bit packer into little-endian u32 words (bio.c:49-72).

    ``close`` flushes the final partial word zero-padded, so the stream
    length is always a whole number of 4-byte words (bio.c:105-112 — the
    reference measures output size after the word-granular flush).
    """

    def __init__(self) -> None:
        self.words: List[int] = []
        self._acc = 0  # bit buffer (bio.b)
        self._n = 0    # bits in buffer (bio.c)

    def write_bit(self, bit: int) -> None:
        self._acc |= (bit & 1) << self._n
        self._n += 1
        if self._n == 32:
            self.words.append(self._acc)
            self._acc = 0
            self._n = 0

    def write_bits(self, value: int, count: int) -> None:
        for i in range(count):
            self.write_bit((value >> i) & 1)

    def close(self) -> bytes:
        if self._n > 0:
            self.words.append(self._acc)
            self._acc = 0
            self._n = 0
        return np.asarray(self.words, dtype="<u4").tobytes()


class BitReader:
    """LSB-first bit unpacker over little-endian u32 words (bio.c:74-103).

    Reads past the end of the buffer yield the sentinel word 0x80000000;
    the reference pre-shrinks its end pointer by 3 bytes (bio.c:11,
    bio.c:30-42), so a word at byte offset ``o`` is readable iff
    ``o < size - 3`` — trailing 1..3 stray bytes are never consumed.
    """

    SENTINEL = 0x80000000

    def __init__(self, data: bytes) -> None:
        size = len(data)
        n_words = max(0, (size - 4) // 4 + 1) if size >= 4 else 0
        pad = (-size) % 4
        self.words = np.frombuffer(data + b"\x00" * pad, dtype="<u4")[:n_words]
        self._widx = 0
        self._acc = 0
        self._n = 32  # start exhausted: first read reloads (bio.c:13)

    def _reload(self) -> None:
        if self._widx < len(self.words):
            self._acc = int(self.words[self._widx])
            self._widx += 1
        else:
            self._acc = self.SENTINEL
        self._n = 0

    def read_bit(self) -> int:
        if self._n == 32:
            self._reload()
        bit = self._acc & 1
        self._acc >>= 1
        self._n += 1
        return bit

    def read_bits(self, count: int) -> int:
        value = 0
        for i in range(count):
            value |= self.read_bit() << i
        return value


# ---------------------------------------------------------------------------
# Adaptive frequency models (ac.c:200-273).
# ---------------------------------------------------------------------------


class AdaptiveModel:
    """A frequency table over symbols 0..n-1, all frequencies starting at 1.

    Coding intervals are [cum(s), cum(s)+freq(s)) out of total(=sum), with
    cumulative frequencies in symbol order (ac.c:6-18).  ``inc`` adds 1 to
    one symbol (ac.c:215-228).  ``enlarge`` appends a fresh symbol with
    frequency 1 (ac.c:250-266) — used by the order-0 index model, which
    grows by one per dictionary insertion.
    """

    def __init__(self, size: int, init_freqs: Optional[Tuple[int, ...]] = None):
        self.freqs: List[int] = list(init_freqs) if init_freqs else [1] * size
        self.total = sum(self.freqs)

    @property
    def count(self) -> int:
        return len(self.freqs)

    def interval(self, sym: int) -> Tuple[int, int, int]:
        low = sum(self.freqs[:sym])
        return low, low + self.freqs[sym], self.total

    def inc(self, sym: int) -> None:
        self.freqs[sym] += 1
        self.total += 1

    def enlarge(self) -> None:
        self.freqs.append(1)
        self.total += 1

    def prob(self, sym: int) -> np.float32:
        """f32 probability estimate, matching C float semantics
        (ac.c:108-113: ``(float)freq / total``)."""
        return np.float32(np.float32(self.freqs[sym]) / np.float32(self.total))


# ---------------------------------------------------------------------------
# 31-bit adaptive arithmetic coder (ac.c).
# ---------------------------------------------------------------------------


class ArithEncoder:
    """Integer arithmetic coder, range [0, 0x7FFFFFFF], quarter scaling with
    an underflow counter (ac.c:35-126)."""

    def __init__(self, out: BitWriter) -> None:
        self.low = 0
        self.high = AC_TOP
        self.scale = 0
        self.out = out

    def encode(self, low_f: int, high_f: int, total: int) -> None:
        step = (self.high - self.low + 1) // total  # ac.c:79 integer division
        self.high = self.low + step * high_f - 1
        self.low = self.low + step * low_f
        # E1/E2 renormalization (ac.c:46-67)
        while self.high < AC_HALF or self.low >= AC_HALF:
            if self.high < AC_HALF:
                self.out.write_bit(0)
                self.low = 2 * self.low
                self.high = 2 * self.high + 1
                while self.scale > 0:
                    self.out.write_bit(1)
                    self.scale -= 1
            else:
                self.out.write_bit(1)
                self.low = 2 * (self.low - AC_HALF)
                self.high = 2 * (self.high - AC_HALF) + 1
                while self.scale > 0:
                    self.out.write_bit(0)
                    self.scale -= 1
        # E3 (ac.c:70-74)
        while AC_FIRST_QUARTER <= self.low and self.high < AC_THIRD_QUARTER:
            self.scale += 1
            self.low = 2 * (self.low - AC_FIRST_QUARTER)
            self.high = 2 * (self.high - AC_FIRST_QUARTER) + 1

    def encode_symbol(self, model: AdaptiveModel, sym: int) -> None:
        low_f, high_f, total = model.interval(sym)
        self.encode(low_f, high_f, total)

    def flush(self) -> None:
        # ac.c:115-126: emit 1 bit, or (scale+2) bits, to pin the interval.
        if self.low < AC_FIRST_QUARTER:
            self.out.write_bit(0)
            for _ in range(self.scale + 1):
                self.out.write_bit(1)
        else:
            self.out.write_bit(1)


class ArithDecoder:
    """Mirror of :class:`ArithEncoder` (ac.c:128-198)."""

    def __init__(self, src: BitReader) -> None:
        self.low = 0
        self.high = AC_TOP
        self.scale = 0
        self.src = src
        self.buffer = 0
        for _ in range(31):  # prime with exactly 31 bits (ac.c:133-140)
            self.buffer = (self.buffer << 1) | src.read_bit()

    def decode_symbol(self, model: AdaptiveModel) -> int:
        total = model.total
        step = (self.high - self.low + 1) // total
        value = (self.buffer - self.low) // step  # ac.c:128-131
        # interval search (ac.c:167-179)
        cum = 0
        sym = None
        for i, f in enumerate(model.freqs):
            if cum <= value < cum + f:
                sym = i
                break
            cum += f
        if sym is None:
            raise ValueError("arithmetic decoder: value outside all intervals")
        self.high = self.low + step * (cum + model.freqs[sym]) - 1
        self.low = self.low + step * cum
        # E1/E2 (ac.c:142-156)
        while self.high < AC_HALF or self.low >= AC_HALF:
            if self.high < AC_HALF:
                self.low = 2 * self.low
                self.high = 2 * self.high + 1
                self.buffer = 2 * self.buffer + self.src.read_bit()
            else:
                self.low = 2 * (self.low - AC_HALF)
                self.high = 2 * (self.high - AC_HALF) + 1
                self.buffer = 2 * (self.buffer - AC_HALF) + self.src.read_bit()
            self.scale = 0
        # E3 (ac.c:159-164)
        while AC_FIRST_QUARTER <= self.low and self.high < AC_THIRD_QUARTER:
            self.scale += 1
            self.low = 2 * (self.low - AC_FIRST_QUARTER)
            self.high = 2 * (self.high - AC_FIRST_QUARTER) + 1
            self.buffer = 2 * (self.buffer - AC_FIRST_QUARTER) + self.src.read_bit()
        return sym


# ---------------------------------------------------------------------------
# Dictionary of fragments, ordered by recency (dict.c).
# ---------------------------------------------------------------------------


class Dictionary:
    """Grow-only set of byte fragments (each 1..32 bytes), kept sorted by
    ascending distance from the current position to the fragment's last use
    (dict.c:132-146).  The array index of an entry is therefore its
    *recency rank*; its ``tag`` is its stable insertion id (dict.c:100).

    All ``last_pos`` values are distinct (positions strictly increase and at
    most one entry is touched per event), so the cost sort is a permutation
    by distinct keys — re-sorting after an event is exactly a move-to-front
    of the touched entry.  The spec still performs the literal stable sort
    to stay a direct transcription of the contract.
    """

    def __init__(self) -> None:
        self.strs: List[bytes] = []     # fragment bytes, in current rank order
        self.lens: List[int] = []
        self.last_pos: List[int] = []   # stream offset of most recent use
        self.tags: List[int] = []       # insertion ids, permuted with rank
        self.next_tag = 0

    @property
    def elems(self) -> int:
        return len(self.strs)

    def find_match(self, data: np.ndarray, p: int) -> int:
        """Longest entry that is an exact prefix of ``data[p:]``; returns its
        current index, or -1 (dict.c:105-130).  The longest match is unique
        (entries are distinct strings), so no tie-break is needed."""
        best_len = 0
        best_i = -1
        view = data[p : p + MAX_MATCH_LEN].tobytes()
        for i in range(self.elems):
            n = self.lens[i]
            if n > best_len and view[:n] == self.strs[i]:
                best_len = n
                best_i = i
        return best_i

    def query_exact(self, frag: bytes) -> bool:
        """Exact duplicate probe (dict.c:148-157)."""
        return frag in self.strs

    def insert(self, frag: bytes, p: int) -> None:
        """Append a new fragment with last_pos=p and the next insertion tag
        (dict.c:91-103, elem_fill at dict.c:51-59)."""
        self.strs.append(frag)
        self.lens.append(len(frag))
        self.last_pos.append(p)
        self.tags.append(self.next_tag)
        self.next_tag += 1

    def update_costs(self, p: int) -> None:
        """Recompute cost = p - last_pos for all entries and stable-sort
        ascending (dict.c:132-146).  Equivalent to ordering by descending
        last_pos."""
        order = sorted(range(self.elems), key=lambda i: p - self.last_pos[i])
        self.strs = [self.strs[i] for i in order]
        self.lens = [self.lens[i] for i in order]
        self.last_pos = [self.last_pos[i] for i in order]
        self.tags = [self.tags[i] for i in order]

    def index_by_tag(self, tag: int) -> int:
        return self.tags.index(tag)  # dict.c:174-183


# ---------------------------------------------------------------------------
# Order-1 / order-2 context tables (context.c) and the (tag,tag)->id map
# (tag_pair.c).
# ---------------------------------------------------------------------------


class ContextTable:
    """Per-context list of (tag, freq) in insertion order.

    A tag is coded through a *throwaway* model whose symbol i carries the
    i-th item's frequency — insertion order, not frequency order, defines
    symbol indices, because the reference's ctx_sort is compiled out
    (context.c:75-86, context.c:95-152)."""

    def __init__(self) -> None:
        self.tags: List[int] = []
        self.freqs: List[int] = []

    def find(self, tag: int) -> int:
        try:
            return self.tags.index(tag)
        except ValueError:
            return -1

    def add_or_inc(self, tag: int) -> None:
        i = self.find(tag)
        if i < 0:
            self.tags.append(tag)
            self.freqs.append(1)
        else:
            self.freqs[i] += 1

    def as_model(self) -> AdaptiveModel:
        return AdaptiveModel(len(self.tags), tuple(self.freqs))


class TagPairMap:
    """(tag0, tag1) -> dense id, ids assigned in insertion order
    (tag_pair.c:100-130; the reference's BST only affects lookup speed, not
    id assignment, so a hash map reproduces it exactly)."""

    def __init__(self) -> None:
        self.map: dict[Tuple[int, int], int] = {}

    def query(self, t0: int, t1: int) -> int:
        return self.map.get((t0, t1), -1)

    def add(self, t0: int, t1: int) -> int:
        nid = len(self.map)
        self.map[(t0, t1)] = nid
        return nid

    @property
    def elems(self) -> int:
        return len(self.map)


# ---------------------------------------------------------------------------
# Match finding (backend.c).
# ---------------------------------------------------------------------------


def window_counts(data: np.ndarray, p: int, window: int) -> np.ndarray:
    """count[i] = number of window positions s in [p+1, p+window-32) whose
    first i+1 bytes equal data[p:p+i+1] (backend.c:56-74).

    Pure function of the input bytes (the data must be zero-padded with
    ``window`` bytes past the logical end, mirroring x3.c:579/590)."""
    counts = np.zeros(MAX_MATCH_LEN, dtype=np.int64)
    lo = p + 1
    hi = p + window - MAX_MATCH_LEN  # exclusive
    if hi <= lo:
        return counts
    n = hi - lo
    win = np.lib.stride_tricks.sliding_window_view(
        data[lo : hi + MAX_MATCH_LEN - 1], MAX_MATCH_LEN
    )[:n]
    eq = win == data[p : p + MAX_MATCH_LEN]
    prefix = np.logical_and.accumulate(eq, axis=1)
    return prefix.sum(axis=0).astype(np.int64)


def find_best_match(
    data: np.ndarray, p: int, dictionary: Dictionary, params: X3Params
) -> int:
    """Pick the longest prefix of data[p:] repeated more than a threshold in
    the forward window; the threshold sweeps down from -t to 1 and two
    "magic factor" heuristics can veto a candidate in favor of an upcoming
    dictionary match (backend.c:76-97).  Returns the chosen length >= 1."""
    counts = window_counts(data, p, params.window)
    for tc in range(params.max_match_count, 0, -1):
        for i in range(MAX_MATCH_LEN - 1, -1, -1):
            if counts[i] > tc:
                if i >= 2 and params.magic_factor1 > 0:
                    d = dictionary.find_match(data, p + i)
                    if d != -1 and dictionary.lens[d] * params.magic_factor1 > i + 1:
                        continue  # backend.c:79-83 veto
                if i >= 1 and params.magic_factor2 > 0:
                    vetoed = False
                    for o in range(1, i + 1):
                        d = dictionary.find_match(data, p + o)
                        if (
                            d != -1
                            and (dictionary.lens[d] - o) * params.magic_factor2 > i + 1
                        ):
                            vetoed = True  # backend.c:84-90 veto
                            break
                    if vetoed:
                        continue
                return i + 1
    return 1


# ---------------------------------------------------------------------------
# Codec state + event codec (x3.c).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Stats:
    """Event counters and estimated coded sizes in bits, mirroring the
    reference's events[]/sizes[] (x3.c:42-43); the est.-vs-real ratio
    self-check (x3.c:677-678) is kept as a test invariant."""

    events: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(E_LAST, dtype=np.int64)
    )
    sizes: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(E_LAST, dtype=np.float32)
    )

    def record(self, event: int, prob: np.float32) -> None:
        self.events[event] += 1
        self.sizes[event] += np.float32(-np.log2(prob))

    @property
    def estimated_bytes(self) -> int:
        total_bits = float(np.ceil(np.float32(self.sizes.sum())))
        return (int(total_bits) + 7) // 8


class CodecState:
    """All adaptive state shared (in identical replicas) by encoder and
    decoder: dictionary, both context families, the pair map and the four
    adaptive models (x3.c:225-249)."""

    def __init__(self) -> None:
        self.dict = Dictionary()
        self.pairs = TagPairMap()
        self.ctx0: List[ContextTable] = [ContextTable()]  # grows with pairs
        self.ctx1: List[ContextTable] = []                # grows with dict
        self.model_events = AdaptiveModel(E_LAST, EVENT_INIT_FREQS)
        self.model_match_size = AdaptiveModel(MAX_MATCH_LEN)
        self.model_chars = AdaptiveModel(256)
        self.model_index1 = AdaptiveModel(0)
        self.stats = Stats()

    # -- shared state-update steps ------------------------------------------

    def ctx_for(self, prev_c1: int, c1: int) -> ContextTable:
        """Resolve the order-2 context: unknown pair falls back to id 0
        (x3.c:63-67, x3.c:141-145)."""
        cid = self.pairs.query(prev_c1, c1)
        return self.ctx0[cid if cid != -1 else 0]

    def update_contexts(self, c0: ContextTable, c1_tbl: ContextTable,
                        context1: int, tag: int) -> None:
        """Post-event context updates shared by encode and decode
        (x3.c:195-222 == x3.c:99-127): bump the tag in both contexts and
        register the new (context1, tag) pair."""
        c0.add_or_inc(tag)
        c1_tbl.add_or_inc(tag)
        if self.pairs.query(context1, tag) == -1:
            self.pairs.add(context1, tag)
            self.ctx0.append(ContextTable())

    def insert_fragment(self, frag: bytes, p: int) -> None:
        """Insert a fragment unless it is an exact duplicate (near the end
        the algorithm re-derives fragments already stored: x3.c:411-420)."""
        if not self.dict.query_exact(frag):
            self.dict.insert(frag, p)
            self.ctx1.append(ContextTable())
            self.model_index1.enlarge()


def encode(data: bytes, params: X3Params = X3Params()) -> bytes:
    """Compress ``data`` to a reference-format x3 stream (x3.c:372-434)."""
    state = CodecState()
    out = BitWriter()
    ac = ArithEncoder(out)

    size = len(data)
    pad = max(params.window, MAX_MATCH_LEN)
    buf = np.frombuffer(data, dtype=np.uint8)
    buf = np.concatenate([buf, np.zeros(pad, dtype=np.uint8)])

    prev_context1 = 0
    context1 = 0
    p = 0
    while p < size:
        index = state.dict.find_match(buf, p)
        dict_len = state.dict.lens[index] if index != -1 else 0
        best = find_best_match(buf, p, state.dict, params)
        if index != -1 and params.nl(dict_len) >= best and p + dict_len <= size:
            # dictionary hit (x3.c:381-397)
            _encode_tag(state, ac, prev_context1, context1, index)
            prev_context1 = context1
            context1 = state.dict.tags[index]
            state.dict.last_pos[index] = p
            p += dict_len
            state.dict.update_costs(p)
        else:
            # new fragment (x3.c:398-428)
            length = min(best, size - p)
            frag = buf[p : p + length].tobytes()
            _encode_new(state, ac, frag)
            state.insert_fragment(frag, p)
            p += length
            prev_context1 = 0
            context1 = 0
            state.dict.update_costs(p)

    # end of stream (x3.c:432-433)
    ac.encode_symbol(state.model_events, E_EOF)
    state.model_events.inc(E_EOF)
    ac.flush()
    stream = out.close()
    encode.last_stats = state.stats  # expose counters for the stats report
    return stream


def _encode_tag(
    state: CodecState, ac: ArithEncoder, prev_c1: int, c1: int, index: int
) -> None:
    """Code a dictionary hit: greedily pick the cheapest of the three
    codings by product probability — the chosen mode is itself coded, so
    the decoder never re-derives this decision (x3.c:131-223)."""
    tag = state.dict.tags[index]
    c0_tbl = state.ctx_for(prev_c1, c1)
    c1_tbl = state.ctx1[c1]

    prob_ctx0 = np.float32(0)
    i0 = c0_tbl.find(tag)
    if i0 >= 0:
        prob_ctx0 = np.float32(
            state.model_events.prob(E_CTX0) * c0_tbl.as_model().prob(i0)
        )
    prob_ctx1 = np.float32(0)
    i1 = c1_tbl.find(tag)
    if i1 >= 0:
        prob_ctx1 = np.float32(
            state.model_events.prob(E_CTX1) * c1_tbl.as_model().prob(i1)
        )
    prob_idx1 = np.float32(
        state.model_events.prob(E_IDX1) * state.model_index1.prob(index)
    )

    # strict-greater comparisons in this order (x3.c:162-172)
    mode, prob = E_IDX1, prob_idx1
    if prob_ctx0 > prob:
        mode, prob = E_CTX0, prob_ctx0
    if prob_ctx1 > prob:
        mode, prob = E_CTX1, prob_ctx1

    ac.encode_symbol(state.model_events, mode)
    state.model_events.inc(mode)

    if mode == E_CTX0:
        ac.encode_symbol(c0_tbl.as_model(), i0)
    elif mode == E_CTX1:
        ac.encode_symbol(c1_tbl.as_model(), i1)
    else:
        ac.encode_symbol(state.model_index1, index)
        state.model_index1.inc(index)

    state.stats.record(mode, prob)
    state.update_contexts(c0_tbl, c1_tbl, c1, tag)


def _encode_new(state: CodecState, ac: ArithEncoder, frag: bytes) -> None:
    """Code a literal fragment: E_NEW, then length-1, then each byte, each
    in its own adaptive model (x3.c:251-270)."""
    st = state.stats
    st.sizes[E_NEW] += -np.log2(state.model_events.prob(E_NEW))
    ac.encode_symbol(state.model_events, E_NEW)
    state.model_events.inc(E_NEW)

    length = len(frag)
    assert 0 < length <= MAX_MATCH_LEN
    st.sizes[E_NEW] += -np.log2(state.model_match_size.prob(length - 1))
    ac.encode_symbol(state.model_match_size, length - 1)
    state.model_match_size.inc(length - 1)

    for b in frag:
        st.sizes[E_NEW] += -np.log2(state.model_chars.prob(b))
        ac.encode_symbol(state.model_chars, b)
        state.model_chars.inc(b)
    st.events[E_NEW] += 1


def decode(stream: bytes) -> bytes:
    """Decompress a reference-format x3 stream (x3.c:285-353): replay the
    encoder's state machine from the event stream, maintaining byte-exact
    replicas of all adaptive state."""
    state = CodecState()
    src = BitReader(stream)
    ac = ArithDecoder(src)

    out = bytearray()
    prev_context1 = 0
    context1 = 0
    while True:
        decision = ac.decode_symbol(state.model_events)
        state.model_events.inc(decision)
        if decision == E_EOF:
            break
        if decision == E_NEW:
            length = ac.decode_symbol(state.model_match_size) + 1
            state.model_match_size.inc(length - 1)
            frag = bytearray()
            for _ in range(length):
                b = ac.decode_symbol(state.model_chars)
                state.model_chars.inc(b)
                frag.append(b)
            state.insert_fragment(bytes(frag), len(out))
            out += frag
            prev_context1 = 0
            context1 = 0
            state.dict.update_costs(len(out))
        else:
            index = _decode_tag(state, ac, decision, prev_context1, context1)
            prev_context1 = context1
            context1 = state.dict.tags[index]
            state.dict.last_pos[index] = len(out)
            out += state.dict.strs[index]
            state.dict.update_costs(len(out))
    return bytes(out)


def _decode_tag(
    state: CodecState, ac: ArithDecoder, decision: int, prev_c1: int, c1: int
) -> int:
    """Mirror of :func:`_encode_tag` for one already-decoded mode
    (x3.c:57-129).  Returns the dictionary index."""
    c0_tbl = state.ctx_for(prev_c1, c1)
    c1_tbl = state.ctx1[c1]

    if decision == E_CTX0:
        tag = c0_tbl.tags[ac.decode_symbol(c0_tbl.as_model())]
        index = state.dict.index_by_tag(tag)
    elif decision == E_CTX1:
        tag = c1_tbl.tags[ac.decode_symbol(c1_tbl.as_model())]
        index = state.dict.index_by_tag(tag)
    elif decision == E_IDX1:
        index = ac.decode_symbol(state.model_index1)
        state.model_index1.inc(index)
        tag = state.dict.tags[index]
    else:
        raise ValueError(f"bad decision {decision}")

    state.update_contexts(c0_tbl, c1_tbl, c1, tag)
    return index
