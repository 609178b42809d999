"""Ratio-at-scale check (round-2 verdict #7): the container's
block-splitting cost on a genuine >= 16 MB diverse corpus.

The multi-lane architecture splits the input into independent blocks
(the only parallelism the format admits, SURVEY.md section 7); each
block restarts codec state, so the compressed total exceeds the
reference's single-stream size.  The seed-dictionary broadcast
(parallel/blocks.py) claws that back.  This measures all three on the
same bytes through the native host codec — bit-identical to the
reference stream for the single-block case (tests/test_host.py) — and
verifies every stream decodes.

Runs on the host CPU only (no accelerator).  Blocks encode in parallel
worker processes.  Usage: python experiments/ratio_at_scale.py [total_mib]
[block_mib] [seed_k]
"""

import pathlib
import sys
import time
from concurrent.futures import ProcessPoolExecutor

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

from bench import build_corpus
from x3tpu import host
from x3tpu.config import X3Params
from x3tpu.parallel import blocks as blk

T0 = time.time()


def log(m):
    print(f"[+{time.time()-T0:7.1f}s] {m}", file=sys.stderr, flush=True)


def _enc(args):
    data, seeds = args
    return host.encode(data, X3Params(), seeds=seeds)


def _enc_warm(args):
    data, seeds, tape = args
    return host.encode(data, X3Params(), seeds=seeds, warm_tape=tape)


def main():
    total_mib = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    block_mib = float(sys.argv[2]) if len(sys.argv) > 2 else 4
    seed_k = int(sys.argv[3]) if len(sys.argv) > 3 else 256

    params = X3Params()
    total = total_mib << 20
    bb = int(block_mib * (1 << 20))
    data = build_corpus(total)
    parts = [data[i : i + bb] for i in range(0, total, bb)]
    log(f"corpus {total_mib} MiB as {len(parts)} x {bb >> 10} KiB blocks")

    def strided_sample(n):
        """n bytes sampled evenly across the corpus (one chunk per block
        region) — a head-only sample over-fits the corpus's first file."""
        per = n // len(parts)
        return b"".join(p[:per] for p in parts)

    seed_cfgs = [
        ("head256K", data[: 256 << 10], seed_k, False),
        ("strided2M", strided_sample(2 << 20), 8192, False),
        ("strided4M", strided_sample(4 << 20), 12288, False),
        ("strided4M-ranked", strided_sample(4 << 20), 12288, True),
        ("strided8M-ranked", strided_sample(8 << 20), 12288, True),
    ]

    with ProcessPoolExecutor(max_workers=min(8, 2 * len(parts))) as ex:
        t0 = time.time()
        plain = list(ex.map(_enc, [(p, None) for p in parts]))
        log(f"split encode (unseeded): {time.time()-t0:.1f}s")
        t0 = time.time()
        (single,) = list(ex.map(_enc, [(data, None)]))
        log(f"single-block encode (reference stream): {time.time()-t0:.1f}s")
        assert host.decode(plain[0], max_output=bb + 64) == parts[0]

        size_single = len(single)
        cont_plain = len(blk.pack_container(
            plain, [len(p) for p in parts], bb))
        print(f"corpus {total_mib} MiB, blocks {len(parts)}x{block_mib} MiB")
        print(f"| variant | bytes | ratio | vs single-block |")
        print(f"| single-block (reference stream) | {size_single} "
              f"| {total/size_single:.4f} | — |")
        print(f"| split unseeded | {cont_plain} | {total/cont_plain:.4f} "
              f"| {100*(cont_plain-size_single)/size_single:+.2f}% |")

        for name, sample, k, ranked in seed_cfgs:
            t0 = time.time()
            strs, lens = host.train_seeds(sample, params, k, ranked=ranked)
            seeds = (strs, lens)
            seed_bytes = [bytes(strs[i][: lens[i]])
                          for i in range(len(lens))]
            seeded = list(ex.map(_enc, [(p, seeds) for p in parts]))
            assert host.decode(
                seeded[0], max_output=bb + 64, seeds=seeds) == parts[0]
            cont = len(blk.pack_container(
                seeded, [len(p) for p in parts], bb, seeds=seed_bytes))
            log(f"{name} k={len(lens)}: {time.time()-t0:.1f}s")
            print(f"| split + seeds {name} (k={len(lens)}) | {cont} "
                  f"| {total/cont:.4f} "
                  f"| {100*(cont-size_single)/size_single:+.2f}% |",
                  flush=True)

        # model warm-start rows (round-3 verdict #6): seeds + warm tape
        # from the same training pass, replayed on both sides
        from x3tpu import warm as warm_mod

        for name, sample, k in [
            ("warm-strided4M", strided_sample(4 << 20), 12288),
            ("warm-strided8M", strided_sample(8 << 20), 12288),
        ]:
            t0 = time.time()
            strs, lens, tape = host.train_tape(sample, params, k)
            tape, _ = warm_mod.decode_tape(warm_mod.encode_tape(tape))
            seeds = (strs, lens)
            seed_bytes = [bytes(strs[i][: lens[i]])
                          for i in range(len(lens))]
            warmed = list(ex.map(_enc_warm,
                                 [(p, seeds, tape) for p in parts]))
            assert host.decode(warmed[0], max_output=bb + 64, seeds=seeds,
                               warm_tape=tape) == parts[0]
            cont = len(blk.pack_container(
                warmed, [len(p) for p in parts], bb, seeds=seed_bytes,
                warm_tape=tape))
            log(f"{name} k={len(lens)} T={len(tape)}: {time.time()-t0:.1f}s")
            print(f"| split + {name} (k={len(lens)}, T={len(tape)}) | "
                  f"{cont} | {total/cont:.4f} "
                  f"| {100*(cont-size_single)/size_single:+.2f}% |",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
