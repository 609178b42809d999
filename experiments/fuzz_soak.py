"""Long-soak randomized differential fuzz (idle-machine background job).

Tiers, by cost:
  A (every trial)   native host codec vs the spec oracle, RANDOM parameters
                    across the full CLI space (-t/-w/-m/-n/-x), random
                    inputs across alphabets/shapes, both decode directions.
  B (every 25th)    XLA lane codec (CPU backend) encode+decode vs spec on a
                    4-block batch.
  C (every 200th)   the product wave path (runtime.encode_wave /
                    decode_wave) on random 64-symbol data that promotes
                    context rows, fixed config (one compile, reused).

Usage: python experiments/fuzz_soak.py [seconds] [seed]
Exits non-zero on the first mismatch, leaving a repro file in the
checkout's fuzz_repro/ directory.
"""

import pathlib
import sys
import time

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from x3tpu import codec, host, spec
from x3tpu.config import CodecCaps, X3Params
from x3tpu.utils import device

device.enable_compile_cache()

BUDGET = float(sys.argv[1]) if len(sys.argv) > 1 else 3600.0
SEED = int(sys.argv[2]) if len(sys.argv) > 2 else 20260818
T0 = time.time()


def log(msg):
    print(f"[soak +{time.time()-T0:7.1f}s] {msg}", flush=True)


def rand_params(rng) -> X3Params:
    return X3Params(
        max_match_count=int(rng.integers(0, 21)),
        window=int(rng.choice([1024, 2048, 4096, 8192, 16384, 32768])),
        magic_factor1=int(rng.integers(0, 9)),
        magic_factor2=int(rng.integers(0, 9)),
        nl_remap=bool(rng.integers(0, 2)),
    )


def rand_input(rng, nmax=1500) -> bytes:
    n = int(rng.integers(0, nmax))
    kind = int(rng.integers(0, 6))
    if kind == 0:
        return rng.bytes(n)
    if kind == 1:
        return bytes(rng.choice(list(b"ab"), n))
    if kind == 2:
        return bytes(rng.choice(list(b"abcdefgh \n\t.,"), n))
    if kind == 3:
        rep = bytes(rng.choice(list(b"xyz01"), max(int(rng.integers(1, 9)), 1)))
        return (rep * (n // max(len(rep), 1) + 1))[:n]
    if kind == 4:  # text-like: words from a tiny vocabulary
        words = [b"the ", b"match ", b"entropy ", b"x3 ", b"block\n",
                 b"dict ", b"context ", b"coder "]
        out = b""
        while len(out) < n:
            out += words[int(rng.integers(len(words)))]
        return out[:n]
    # structured binary: low-entropy LE u32 deltas
    base = rng.integers(0, 1 << 16)
    vals = base + np.cumsum(rng.integers(0, 4, max(n // 4, 1)))
    return vals.astype("<u4").tobytes()[:n]


def save_repro(tag, data, params):
    out = ROOT / "fuzz_repro"
    out.mkdir(exist_ok=True)
    path = out / f"fuzz_fail_{tag}_{int(time.time())}.npz"
    np.savez(path, data=np.frombuffer(data, np.uint8),
             params=np.array([params.max_match_count, params.window,
                              params.magic_factor1, params.magic_factor2,
                              int(params.nl_remap)]))
    log(f"REPRO SAVED: {path}  params={params}")
    return path


def tier_a(rng):
    data = rand_input(rng)
    params = rand_params(rng)
    s_spec = spec.encode(data, params)
    s_host = host.encode(data, params)
    if s_host != s_spec:
        save_repro("host_enc", data, params)
        raise AssertionError("host vs spec encode mismatch")
    if spec.decode(s_spec) != data:
        save_repro("spec_dec", data, params)
        raise AssertionError("spec decode mismatch")
    if host.decode(s_host, max_output=1 << 20) != data:
        save_repro("host_dec", data, params)
        raise AssertionError("host decode mismatch")
    return len(data)


# tier B draws from a FIXED parameter pool: every distinct X3Params is a
# fresh XLA compilation held in process memory, and fully random params
# exhausted LLVM section memory after ~700 trials (observed 2026-08-18)
TIER_B_PARAMS = [
    X3Params(max_match_count=t, window=1024, magic_factor1=m,
             magic_factor2=n, nl_remap=x)
    for (t, m, n, x) in [
        (3, 4, 0, False), (15, 4, 0, False), (1, 0, 0, False),
        (7, 2, 3, True), (0, 8, 8, False), (4, 1, 1, True),
    ]
]


def tier_b(rng):
    params = TIER_B_PARAMS[int(rng.integers(len(TIER_B_PARAMS)))]
    caps = CodecCaps(dict_cap=512, pair_cap=2048, ctx_items_cap=128,
                     ctx0_items_cap=128, block_bytes=1024)
    blocks = [rand_input(rng)[:1024] for _ in range(4)]
    streams = codec.encode_blocks(blocks, params, caps)
    for i, b in enumerate(blocks):
        if streams[i] != spec.encode(b, params):
            save_repro(f"xla_enc{i}", b, params)
            raise AssertionError(f"XLA vs spec mismatch block {i}")
    outs = codec.decode_blocks(streams, params, caps)
    for i, b in enumerate(blocks):
        if outs[i] != b:
            save_repro(f"xla_dec{i}", b, params)
            raise AssertionError(f"XLA decode mismatch block {i}")
    return sum(map(len, blocks))


# tier C: one fixed config and data length, so the programs compile once;
# random 64-symbol data promotes context rows past the 16-item small pool
PROMO_PARAMS = X3Params(max_match_count=15, window=32)
PROMO_CAPS = CodecCaps(dict_cap=512, pair_cap=4096, ctx_items_cap=1024,
                       ctx0_items_cap=1024, ctx_small_cap=16,
                       block_bytes=8192)


def tier_c(rng):
    from x3tpu.parallel import runtime

    blocks = [rng.integers(1, 65, 6000, np.uint8).tobytes(), b""]
    enc = runtime.encode_wave(blocks, PROMO_PARAMS, PROMO_CAPS)
    for i, b in enumerate(blocks):
        if enc.payloads[i] != spec.encode(b, PROMO_PARAMS):
            save_repro(f"promo_enc{i}", b, PROMO_PARAMS)
            raise AssertionError(f"promoted-rows XLA vs spec mismatch {i}")
    dec = runtime.decode_wave(enc.payloads, [len(b) for b in blocks],
                              PROMO_PARAMS, PROMO_CAPS)
    if dec.payloads != blocks:
        save_repro("promo_dec", blocks[0], PROMO_PARAMS)
        raise AssertionError("promoted-rows XLA decode mismatch")
    return sum(map(len, blocks))


def main():
    rng = np.random.default_rng(SEED)
    trials = fuzzed = 0
    nb = nc = 0
    while time.time() - T0 < BUDGET:
        fuzzed += tier_a(rng)
        trials += 1
        if trials % 25 == 0:
            fuzzed += tier_b(rng)
            nb += 1
        if trials % 200 == 0:
            fuzzed += tier_c(rng)
            nc += 1
        if trials % 100 == 0:
            log(f"{trials} trials ({nb} XLA, {nc} promoted-row batches), "
                f"{fuzzed/1e6:.1f} MB fuzzed, all exact")
        if trials % 500 == 0:
            # XLA:CPU JIT executables accumulate in a bounded LLVM section
            # arena; a multi-hour soak exhausts it (~1600 trials observed
            # twice) — drop the compile caches and re-trace
            jax.clear_caches()
    log(f"DONE: {trials} trials ({nb} XLA, {nc} promoted-row), "
        f"{fuzzed/1e6:.1f} MB, 0 mismatches (seed {SEED})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
