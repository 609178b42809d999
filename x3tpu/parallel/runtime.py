"""High-level compression runtime: block splitting, capacity heuristics,
wave scheduling over the mesh, overflow auto-retry, in-order gather.

This is the x3tpu equivalent of the reference's main() driver
(x3.c:479-702) scaled to a device mesh; per-block payloads remain
reference-format streams.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import jax
import numpy as np

from x3tpu import codec
from x3tpu.config import CodecCaps, X3Params
from x3tpu.parallel import blocks as blk
from x3tpu.parallel import mesh as meshmod
from x3tpu.utils.stats import CodecStats


class WaveJournal:
    """Crash-safe per-wave checkpoint for long compressions (no reference
    counterpart: the reference aborts on any failure, SURVEY.md §5).

    Completed waves append (wave_index, payloads) records under a job
    fingerprint; re-running the same job resumes after the last completed
    wave.  Records are self-framed pickles on a single append-only file."""

    def __init__(self, path: str, fingerprint: bytes):
        import pickle

        self.path = path
        self.fingerprint = fingerprint
        self.done: dict = {}
        self.seed_bytes = None
        try:
            with open(path, "rb") as f:
                head = pickle.load(f)
                if head.get("fingerprint") == fingerprint:
                    while True:
                        try:
                            rec = pickle.load(f)
                        except EOFError:
                            break
                        if rec.get("kind") == "seeds":
                            self.seed_bytes = rec["seeds"]
                        else:
                            self.done[rec["wave"]] = (
                                rec["payloads"], rec.get("stats")
                            )
        except Exception:
            self.done = {}
        if not self.done and self.seed_bytes is None:
            import pickle

            with open(path, "wb") as f:
                pickle.dump({"fingerprint": fingerprint}, f)

    def record_seeds(self, seed_bytes) -> None:
        import pickle

        with open(self.path, "ab") as f:
            pickle.dump({"kind": "seeds", "seeds": seed_bytes}, f)
        self.seed_bytes = seed_bytes

    def record(self, wave: int, payloads, stats=None) -> None:
        import pickle

        with open(self.path, "ab") as f:
            pickle.dump({"kind": "wave", "wave": wave,
                         "payloads": payloads, "stats": stats}, f)
        self.done[wave] = (payloads, stats)

    def finish(self) -> None:
        import os

        try:
            os.unlink(self.path)
        except OSError:
            pass


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def caps_for_block(block_bytes: int) -> CodecCaps:
    """Heuristic capacities for a block size, from measured state growth
    (``host.measure_state``; 17 KB source text -> dict 372, pairs 2522,
    hub ctx ~150 items; SURVEY.md §7 hard part #2).  Capacities never
    shape the stream, only whether the state fits; the overflow
    auto-retry covers the tail."""
    # measured dictionary growth is ~block/20 entries on text; block/16
    # with pow2 rounding plus overflow auto-retry covers the tail
    d = int(np.clip(_pow2(block_bytes // 16), 1 << 10, 1 << 16))
    # past the pow2 step, 24576 covers the measured 4 MiB diverse-binary
    # need (21770 entries) and 16 MiB text (11914); a genuine overflow
    # auto-retries at 49152
    if d > 24576:
        d = 24576
    items = int(np.clip(_pow2(d // 4), 256, 2048))
    if d <= 8192:
        # blocks to 512 KiB: measured per-context growth stays far below
        # 640 items (test_caps_calibration), so the promoted rows, which
        # every lane carries at full width, stay small
        items = min(items, 640)
    elif block_bytes <= 4 << 20:
        # MB-block regime: rows grow to thousands of items (measured 7449
        # max at 4 MiB diverse binary)
        items = 8192
    else:
        # 8-16 MiB blocks: measured on text (ctx1 max 2821 at 16 MiB);
        # diverse binary at these sizes needs a larger dictionary and is
        # served by the overflow auto-retry
        items = 4096
    # tiered context storage: the small pool costs pair_cap*16*8B/lane and
    # each promoted row items*8B (+4B pair ids in ctx1) per lane — measured
    # growth at 4 MiB diverse binary is 391K pairs / 7.4K max items (the
    # 32x multiplier applies only in the MB-block regime).  Blocks past 4 MiB get the 1M
    # pair cap (16 MiB text measures 517K pairs), 4 MiB and below 512K.
    pair = min((32 if d > 8192 else 16) * d,
               1 << (20 if block_bytes > 4 << 20 else 19))
    # ctx0 (pair-context) rows stay an order smaller than ctx1 rows
    # (measured 1257 vs 7449 max at 4 MiB; 2506 at 16 MiB text)
    items0 = min(items, 2048 if block_bytes <= 4 << 20 else 4096)
    # big-row pools, one per family: non-hub rows past the 16-item small
    # pool (host.measure_state *_promoted) — measured 2218 ctx1 / 8368
    # ctx0 rows at 4 MiB diverse binary, 4862 / 10637 at 16 MiB text
    promo1 = min(max(pair // 8, 16), 4096 if block_bytes <= 4 << 20 else 8192)
    promo0 = min(max(pair // 32, 16), 16384)
    return CodecCaps(
        dict_cap=d,
        pair_cap=pair,
        ctx_items_cap=items,
        ctx0_items_cap=items0,
        ctx_promo_rows=promo1,
        ctx0_promo_rows=promo0,
        block_bytes=block_bytes,
    )


@dataclasses.dataclass
class RunResult:
    payloads: List[bytes]
    stats: CodecStats


def _wave_lanes(nblocks: int, mesh, lanes_per_device: int = 0) -> int:
    """Lanes per wave: a multiple of the mesh size covering the blocks,
    bounded by lanes_per_device (0 = unbounded)."""
    nd = mesh.devices.size if mesh is not None else 1
    lanes = int(math.ceil(nblocks / nd)) * nd
    if lanes_per_device > 0:
        lanes = min(lanes, nd * lanes_per_device)
    return max(lanes, 1)


def seeds_to_arrays(seed_bytes: Sequence[bytes]):
    """Seed fragments -> (strs u8 [K, 32], lens i32 [K]) arrays."""
    strs = np.zeros((len(seed_bytes), 32), np.uint8)
    lens = np.zeros((len(seed_bytes),), np.int32)
    for i, b in enumerate(seed_bytes):
        strs[i, : len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    import jax.numpy as jnp

    return jnp.asarray(strs), jnp.asarray(lens)


def _warm_for(warm_arrays, caps):
    """WarmArrays -> the codec's warm dict (None passes through)."""
    if warm_arrays is None:
        return None
    from x3tpu import warm as warm_mod

    return warm_mod.for_xla(warm_arrays, caps.ctx_small_cap)


def _no_sharded_warm(warm) -> None:
    # dropping the warm state silently would emit streams the decoder
    # cannot reproduce: refuse instead (the sharded warm init is unbuilt)
    if warm is not None:
        raise RuntimeError("warm start is not supported on a device mesh")


def encode_wave(
    blocks_in: Sequence[bytes],
    params: X3Params,
    caps: CodecCaps,
    mesh=None,
    max_retries: int = 3,
    seeds=None,
    warm=None,
) -> RunResult:
    """Encode one wave of blocks (padded to the mesh), with capacity
    auto-retry: any lane overflow re-runs the wave at doubled capacities
    (recompiles, but preserves exact reference-format output)."""
    nblocks = len(blocks_in)
    lanes = _wave_lanes(nblocks, mesh)
    padded = list(blocks_in) + [b""] * (lanes - nblocks)
    if mesh is not None:
        _no_sharded_warm(warm)
    for attempt in range(max_retries + 1):
        text, tlen = codec.pack_blocks(padded, params, caps)
        try:
            if mesh is not None:
                words, byte_lens, counts, sizes, overflow = (
                    meshmod.encode_sharded(text, tlen, params, caps, mesh,
                                           seeds=seeds))
            else:
                words, byte_lens, counts, sizes, overflow = (
                    codec.encode_blocks_chunked(
                        jax.numpy.asarray(text), jax.numpy.asarray(tlen),
                        params, caps, seeds, warm=_warm_for(warm, caps)))
            codec._check_overflow(overflow)
            break
        except codec.X3CapacityError as e:
            if attempt == max_retries:
                raise
            caps = caps.scaled(2)
            if "out" in e.flags:
                # scaled() grows only the state caps; an output-buffer
                # overflow (stream larger than out_words) needs headroom
                # growth or every retry re-runs into the same flag
                caps = dataclasses.replace(
                    caps, out_words_factor=caps.out_words_factor * 2
                )
    words_np = np.asarray(words)
    lens_np = np.asarray(byte_lens)
    payloads = [
        words_np[i].astype("<u4").tobytes()[: lens_np[i]] for i in range(nblocks)
    ]
    stats = CodecStats.from_arrays(
        np.asarray(counts)[:nblocks], np.asarray(sizes)[:nblocks]
    )
    return RunResult(payloads, stats)


def decode_wave(
    payloads: Sequence[bytes],
    orig_lens: Sequence[int],
    params: X3Params,
    caps: CodecCaps,
    mesh=None,
    max_retries: int = 3,
    seeds=None,
    warm=None,
) -> RunResult:
    nblocks = len(payloads)
    lanes = _wave_lanes(nblocks, mesh)
    iw = max(1, max(((len(s) + 3) // 4 for s in payloads), default=1))
    words = np.zeros((lanes, iw), np.uint32)
    byte_lens = np.zeros((lanes,), np.int32)
    for i, s in enumerate(payloads):
        pad = (-len(s)) % 4
        arr = np.frombuffer(s + b"\x00" * pad, "<u4")
        words[i, : len(arr)] = arr
        byte_lens[i] = len(s)
    # empty-pad lanes hold a stream that decodes to nothing? an empty input
    # stream reads sentinel words and may decode garbage -- mark them done
    # by giving them the 4-byte empty-input stream.
    if lanes > nblocks:
        from x3tpu import spec

        # the event-model state at EOF is seed-independent for an empty
        # input, so the unseeded empty stream decodes cleanly with or
        # without a seed dictionary
        empty_stream = spec.encode(b"")
        empty = np.frombuffer(empty_stream, "<u4")
        for i in range(nblocks, lanes):
            words[i, : len(empty)] = empty
            byte_lens[i] = 4 * len(empty)

    if mesh is not None:
        _no_sharded_warm(warm)
    for attempt in range(max_retries + 1):
        try:
            if mesh is not None:
                out, out_lens, counts, sizes, overflow = (
                    meshmod.decode_sharded(words, byte_lens, params, caps,
                                           mesh, seeds=seeds))
            else:
                out, out_lens, counts, sizes, overflow = (
                    codec.decode_blocks_chunked(
                        jax.numpy.asarray(words),
                        jax.numpy.asarray(byte_lens), params, caps, seeds,
                        warm=_warm_for(warm, caps)))
            codec._check_overflow(overflow)
            break
        except codec.X3CapacityError as e:
            if attempt == max_retries:
                raise
            caps = caps.scaled(2)
            if "out" in e.flags:
                caps = dataclasses.replace(caps, block_bytes=caps.block_bytes * 2)
    out_np = np.asarray(out)
    lens_np = np.asarray(out_lens)
    results = []
    for i in range(nblocks):
        n = lens_np[i]
        if orig_lens and orig_lens[i] is not None and orig_lens[i] != n:
            raise ValueError(
                f"block {i}: decoded {n} bytes, expected {orig_lens[i]}"
            )
        results.append(out_np[i, :n].tobytes())
    stats = CodecStats.from_arrays(
        np.asarray(counts)[:nblocks], np.asarray(sizes)[:nblocks]
    )
    return RunResult(results, stats)


def compress(
    data: bytes,
    params: X3Params = X3Params(),
    block_bytes: Optional[int] = None,
    caps: Optional[CodecCaps] = None,
    mesh=None,
    force_container: bool = False,
    stats_out: Optional[list] = None,
    dict_seed: bool = False,
    seed_k: int = 256,
    seed_sample: int = 64 * 1024,
    journal_path: Optional[str] = None,
    lanes_per_device: int = 32,
    warm_start: bool = False,
) -> bytes:
    """Compress ``data``.  Single block -> raw reference-format stream
    (interoperable with the reference binary); multiple blocks -> container
    with per-block reference-format payloads.

    ``dict_seed`` trains a shared seed dictionary on a sample of the input
    (native host codec) and broadcasts it to every block — an x3tpu
    extension that recovers ratio lost to per-block state resets (the
    seeds travel in the container header).  ``warm_start`` (implies
    dict_seed) additionally warm-starts the context/pair models from the
    training event tape (x3tpu/warm.py; the tape travels in the
    container too — container flag bit 1)."""
    if warm_start:
        dict_seed = True
    if block_bytes is None:
        block_bytes = max(len(data), 1)
    parts = blk.split_blocks(data, block_bytes)
    if caps is None:
        caps = caps_for_block(
            min(block_bytes, max(len(max(parts, key=len)), 1024)))
    wave = _wave_lanes(len(parts), mesh, lanes_per_device)
    journal = None
    if journal_path is not None:
        import hashlib

        # the fingerprint includes the wave partitioning: resuming with a
        # different mesh size / lanes_per_device must NOT splice waves
        # recorded at another width (block<->wave mapping would shift)
        fp = hashlib.sha256(
            repr((params, block_bytes, dict_seed, seed_k, len(data),
                  wave, warm_start)).encode()
            + data[:4096]
            + data[-4096:]
        ).digest()
        journal = WaveJournal(journal_path, fp)

    seed_bytes: List[bytes] = []
    seeds = None
    warm_tape: List[int] = []
    warm_arrays = None
    if dict_seed and len(parts) > 1:
        if (journal is not None and journal.seed_bytes is not None
                and not warm_start):
            seed_bytes = journal.seed_bytes
        else:
            from x3tpu import host

            # STRIDED sample (one slice per block region), usage-ranked:
            # a head-only sample over-fits the input's first file and
            # measured ratio-NEGATIVE on a 16 MiB diverse corpus, while
            # strided samples recovered ~half the block-splitting loss
            # (BENCH_NOTES.md "Ratio at scale")
            per = max(seed_sample // max(len(parts), 1), 1)
            sample = b"".join(p[:per] for p in parts)
            if warm_start:
                strs, lens, warm_tape = host.train_tape(
                    sample, params, min(seed_k, caps.dict_cap // 2),
                )
            else:
                strs, lens = host.train_seeds(
                    sample, params, min(seed_k, caps.dict_cap // 2),
                    ranked=True,
                )
            seed_bytes = [bytes(strs[i][: lens[i]]) for i in range(len(lens))]
            if journal is not None:
                journal.record_seeds(seed_bytes)
        if seed_bytes:
            seeds = seeds_to_arrays(seed_bytes)
        if warm_start and seed_bytes and warm_tape:
            from x3tpu import warm as warm_mod

            # canonicalize through the wire format (collapse/trim) so the
            # encoder replays EXACTLY what the decoder will read back
            warm_tape, _ = warm_mod.decode_tape(
                warm_mod.encode_tape(warm_tape))
            warm_arrays = warm_mod.pack(
                warm_mod.replay(warm_tape, len(seed_bytes)))
            warm_mod.check_fits(
                warm_arrays, caps.dict_cap, caps.pair_cap,
                caps.ctx_small_cap, min(caps.dict_cap, 8192))
    all_payloads: List[bytes] = []
    all_stats = CodecStats.zero()
    for i in range(0, len(parts), wave):
        widx = i // wave
        if journal is not None and widx in journal.done:
            done_payloads, done_stats = journal.done[widx]
            all_payloads.extend(done_payloads)
            if done_stats is not None:
                all_stats = all_stats.merge(done_stats)
            continue
        res = encode_wave(parts[i : i + wave], params, caps, mesh,
                          seeds=seeds, warm=warm_arrays)
        if journal is not None:
            journal.record(widx, res.payloads, res.stats)
        all_payloads.extend(res.payloads)
        all_stats = all_stats.merge(res.stats)
    if stats_out is not None:
        stats_out.append(all_stats)
    if journal is not None:
        journal.finish()
    if (len(all_payloads) == 1 and not force_container and not seed_bytes
            # a raw stream that happens to begin with the container magic
            # (adversarially constructible) would be misrouted by
            # decompress(); wrap it so our own outputs stay unambiguous
            and not blk.is_container(all_payloads[0])):
        return all_payloads[0]
    return blk.pack_container(
        all_payloads, [len(p) for p in parts], block_bytes,
        seeds=seed_bytes, warm_tape=warm_tape,
    )


def decompress(
    data: bytes,
    params: X3Params = X3Params(),
    caps: Optional[CodecCaps] = None,
    mesh=None,
    max_output: Optional[int] = None,
    stats_out: Optional[list] = None,
    lanes_per_device: int = 32,
) -> bytes:
    """Decompress raw reference-format streams or x3tpu containers."""
    if blk.is_container(data):
        (payloads, orig_lens, block_bytes, seed_bytes,
         warm_tape) = blk.unpack_container(data)
        seeds = seeds_to_arrays(seed_bytes) if seed_bytes else None
        warm_arrays = None
        if warm_tape:
            from x3tpu import warm as warm_mod

            warm_arrays = warm_mod.pack(
                warm_mod.replay(warm_tape, len(seed_bytes)))
        caps = caps or caps_for_block(max(block_bytes, 1024))
        if caps.block_bytes < block_bytes:
            caps = dataclasses.replace(caps, block_bytes=block_bytes)
        out_parts: List[bytes] = []
        all_stats = CodecStats.zero()
        wave = _wave_lanes(len(payloads), mesh, lanes_per_device)
        for i in range(0, len(payloads), wave):
            res = decode_wave(
                payloads[i : i + wave], orig_lens[i : i + wave], params, caps,
                mesh, seeds=seeds, warm=warm_arrays,
            )
            out_parts.extend(res.payloads)
            all_stats = all_stats.merge(res.stats)
        if stats_out is not None:
            stats_out.append(all_stats)
        return b"".join(out_parts)
    # raw stream: output size unknown a priori (headerless format).  Start
    # from a 64:1 guess like the reference (x3.c:621) but *retry* on
    # overflow instead of crashing.
    guess = max_output or max(64 * len(data), 1 << 16)
    caps = caps or caps_for_block(guess)
    if caps.block_bytes < guess:
        caps = dataclasses.replace(caps, block_bytes=guess)
    res = decode_wave([data], [None], params, caps, mesh)
    if stats_out is not None:
        stats_out.append(res.stats)
    return res.payloads[0]
