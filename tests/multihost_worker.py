"""Worker for the 2-process multi-host test (run by test_parallel.py).

Usage: python multihost_worker.py <process_id> <num_processes> <port> <outdir>

Each process encodes its own lanes on its local CPU device mesh, then the
variable-length in-order gather (distributed.gather_payloads_in_order)
collects every payload on process 0 — the multi-host topology of
x3tpu/parallel/distributed.py exercised with real separate processes.
"""

import pathlib
import sys

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import numpy as np

from x3tpu import codec
from x3tpu.config import CodecCaps, X3Params
from x3tpu.parallel import distributed as dist


def main() -> int:
    pid_arg, nproc, port, outdir = (
        int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )
    pid = dist.init_multihost(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc,
        process_id=pid_arg,
    )
    assert pid == pid_arg, (pid, pid_arg)
    assert jax.process_count() == nproc, jax.process_count()
    # the global device view spans every process's local devices
    assert len(jax.devices()) >= nproc, jax.devices()
    assert dist.global_mesh().devices.size == len(jax.devices())

    params = X3Params(max_match_count=4, window=256)
    caps = CodecCaps(
        dict_cap=512, pair_cap=1024, ctx_items_cap=128, ctx0_items_cap=128,
        ctx_small_cap=16, block_bytes=512,
    )
    lanes_per_proc = 2
    all_blocks = [
        bytes(f"multihost lane {i} payload ", "ascii") * (8 + 3 * i)
        for i in range(nproc * lanes_per_proc)
    ]
    lane_offset = pid * lanes_per_proc
    mine = all_blocks[lane_offset : lane_offset + lanes_per_proc]

    text, tlen = codec.pack_blocks([b[:512] for b in mine], params, caps)
    words, byte_lens, _, _, of = codec.encode_blocks_chunked(
        jax.numpy.asarray(text), jax.numpy.asarray(tlen), params, caps
    )
    for f in of._fields:
        assert not np.asarray(getattr(of, f)).any(), f"overflow {f}"
    words, byte_lens = np.asarray(words), np.asarray(byte_lens)
    payloads = [
        words[i].astype("<u4").tobytes()[: byte_lens[i]]
        for i in range(lanes_per_proc)
    ]

    gathered = dist.gather_payloads_in_order(
        payloads, lane_offset, nproc * lanes_per_proc
    )
    if pid != 0:
        assert gathered is None
        return 0

    assert gathered is not None and len(gathered) == nproc * lanes_per_proc
    # decode every gathered payload (any process's lanes) and check bytes
    for i, (payload, orig) in enumerate(zip(gathered, all_blocks)):
        assert len(payload) > 0, f"lane {i} empty"
    wmax = max(len(p) for p in gathered)
    wwords = (wmax + 3) // 4
    arr = np.zeros((len(gathered), wwords), "<u4")
    lens = np.zeros((len(gathered),), np.int32)
    for i, p in enumerate(gathered):
        pad = p + b"\x00" * (-len(p) % 4)
        arr[i, : len(pad) // 4] = np.frombuffer(pad, "<u4")
        lens[i] = len(p)
    out, out_lens, _, _, dof = codec.decode_blocks_chunked(
        jax.numpy.asarray(arr.view(np.uint32).astype(np.uint32)),
        jax.numpy.asarray(lens), params, caps,
    )
    out, out_lens = np.asarray(out), np.asarray(out_lens)
    for i, orig in enumerate(all_blocks):
        want = orig[:512]
        got = out[i, : out_lens[i]].tobytes()
        assert got == want, f"lane {i}: {len(got)}B != {len(want)}B"
    pathlib.Path(outdir, "ok").write_text("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
