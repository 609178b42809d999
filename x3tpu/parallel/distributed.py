"""Multi-host runtime (SURVEY.md §5 "distributed communication backend" —
no reference counterpart; the reference is one process, one thread).

Topology model: one process per host drives every card of that host (a
host with four GPUs is one process, with no `jax.distributed`).  Across
hosts, every host runs the same program; `jax.distributed` bootstraps the
global device view; blocks are sharded over the *global* 1-D `blocks`
mesh, and the network carries only the final in-order payload gather and
the replicated seed broadcast — both tiny next to the sharded
text/outputs, which never leave their devices.

Fault/elasticity posture: compression state is per-block, so host failure
only loses in-flight waves; the wave journal (runtime.WaveJournal) makes a
restarted job resume after the last completed wave.

This module is exercised in CI single-process (the virtual 8-device CPU
mesh) and as a real 2-process CPU cluster on localhost
(tests/multihost_worker.py).
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import numpy as np

import jax


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Initialize jax.distributed (idempotent).  With no arguments, relies
    on a cluster environment JAX can auto-detect (e.g. SLURM); outside one
    this is a no-op.  Returns this process's id."""
    # idempotency probe that does NOT touch the backend (jax.process_count
    # would initialize XLA, after which distributed.initialize refuses)
    from jax._src import distributed as _jdist

    if _jdist.global_state.client is not None:
        return jax.process_index()
    if coordinator_address is not None:
        # explicit cluster request: a failure here means a misconfigured
        # cluster — degrading silently to single-host would quietly do
        # 1/N of the work, so let it raise
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        return jax.process_index()
    try:
        jax.distributed.initialize()
    except (RuntimeError, ValueError) as e:
        # no cluster environment to auto-detect: normal single-host path
        logging.getLogger(__name__).info(
            "jax.distributed auto-init unavailable (%s); single-host", e
        )
    return jax.process_index()


def global_mesh():
    """1-D 'blocks' mesh over every device of every host."""
    from x3tpu.parallel.mesh import make_mesh

    return make_mesh(devices=jax.devices())


def gather_payloads_in_order(
    local_payloads: Sequence[bytes], lane_offset: int, total_lanes: int
) -> Optional[List[bytes]]:
    """Collect per-host compressed payloads on process 0, in global lane
    order (lengths first, then padded bytes — the standard variable-length
    all-gather recipe).  Returns the ordered list on process 0, None on
    other processes.  Single-process: identity."""
    if jax.process_count() == 1:
        return list(local_payloads)

    from jax.experimental import multihost_utils

    lens = np.zeros((total_lanes,), np.int32)
    for i, p in enumerate(local_payloads):
        lens[lane_offset + i] = len(p)
    lens = multihost_utils.process_allgather(lens).sum(axis=0)

    width = int(lens.max()) if total_lanes else 0
    buf = np.zeros((total_lanes, max(width, 1)), np.uint8)
    for i, p in enumerate(local_payloads):
        buf[lane_offset + i, : len(p)] = np.frombuffer(p, np.uint8)
    buf = multihost_utils.process_allgather(buf).sum(axis=0, dtype=np.uint8)

    if jax.process_index() != 0:
        return None
    return [buf[i, : lens[i]].tobytes() for i in range(total_lanes)]
