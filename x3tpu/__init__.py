"""x3tpu — block-parallel lossless data compression on JAX devices.

Re-implements, from scratch, the capabilities of the experimental ``x3``
dictionary compressor (reference: xbarin02/x3-compressor, surveyed in
SURVEY.md) as an idiomatic JAX/XLA system:

* :mod:`x3tpu.spec` — executable format specification (NumPy oracle codec).
* :mod:`x3tpu.ops` — lane-parallel bit I/O, arithmetic coder and match kernels.
* :mod:`x3tpu.models` — adaptive probability models, contexts, dictionary state.
* :mod:`x3tpu.codec` — the lane-batched fixed-shape event-loop codec.
* :mod:`x3tpu.parallel` — device-mesh runtime, block splitting, container format.
* :mod:`x3tpu.utils` — stats, timing, profiling.
* :mod:`x3tpu.cli` — reference-compatible command-line interface.

The compressed *payload* format is bit-identical to the reference x3 stream
(headerless, self-describing; see SURVEY.md §0 for the invariant table), so
single-block output interoperates with the reference binary in both
directions.  Multi-block/multi-chip output adds a thin container frame
(:mod:`x3tpu.parallel.blocks`).
"""

from x3tpu.config import X3Params, CodecCaps

__version__ = "0.1.0"

__all__ = ["X3Params", "CodecCaps", "compress", "decompress", "__version__"]


def __getattr__(name):
    # one-call library API (lazy: importing x3tpu must not pull jax, so
    # callers can still pick a platform via jax.config first)
    if name in ("compress", "decompress"):
        from x3tpu.parallel import runtime

        return getattr(runtime, name)
    raise AttributeError(f"module 'x3tpu' has no attribute {name!r}")
