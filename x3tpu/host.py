"""ctypes bindings for the native host codec (native/x3host.cpp).

The shared library is built on demand with g++ (no pip deps; the image has
no pybind11).  Used as the CPU fallback path for small inputs and as the
at-scale bit-exactness oracle in tests and benchmarks.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading
from typing import Optional

from x3tpu.config import X3Params

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_SRC = _ROOT / "native" / "x3host.cpp"
_LIB = _ROOT / "native" / "libx3host.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class HostCodecUnavailable(RuntimeError):
    pass


def _build() -> None:
    cmd = [
        "g++", "-O2", "-std=c++17", "-shared", "-fPIC",
        str(_SRC), "-o", str(_LIB),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        detail = getattr(e, "stderr", b"")
        raise HostCodecUnavailable(
            f"cannot build native host codec: {e}\n{detail!r}"
        )


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            _build()
        lib = ctypes.CDLL(str(_LIB))
        lib.x3h_encode.restype = ctypes.c_int
        lib.x3h_encode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_long,
            ctypes.c_long, ctypes.c_long, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.x3h_decode.restype = ctypes.c_int
        lib.x3h_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.x3h_free.restype = None
        lib.x3h_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.x3h_measure.restype = None
        lib.x3h_measure.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_long,
            ctypes.c_long, ctypes.c_long, ctypes.c_int, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.x3h_encode_seeded.restype = ctypes.c_int
        lib.x3h_encode_seeded.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_long,
            ctypes.c_long, ctypes.c_long, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.x3h_decode_seeded.restype = ctypes.c_int
        lib.x3h_decode_seeded.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        for tr in ("x3h_train", "x3h_train_ranked"):
            fn = getattr(lib, tr)
            fn.restype = ctypes.c_size_t
            fn.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_size_t,
            ]
        lib.x3h_train_tape.restype = ctypes.c_size_t
        lib.x3h_train_tape.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
            ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.x3h_encode_warm.restype = ctypes.c_int
        lib.x3h_encode_warm.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_long,
            ctypes.c_long, ctypes.c_long, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_size_t,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.x3h_decode_warm.restype = ctypes.c_int
        lib.x3h_decode_warm.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_size_t,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        _lib = lib
        return lib


def _tape_ptr(tape):
    """Tape list (seed indices; warm.RESET -> -1) -> ctypes i32 pointer."""
    import numpy as np

    from x3tpu import warm as warm_mod

    arr = np.asarray(
        [-1 if s == warm_mod.RESET else s for s in tape], np.int32
    )
    arr = np.ascontiguousarray(arr)
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(arr), arr


def _take(lib, out_ptr, out_size) -> bytes:
    try:
        return ctypes.string_at(out_ptr, out_size.value)
    finally:
        lib.x3h_free(out_ptr)


def _seed_ptrs(seeds):
    """(strs u8 [K, 32], lens i32 [K]) numpy arrays -> ctypes pointers."""
    import numpy as np

    strs = np.ascontiguousarray(np.asarray(seeds[0], np.uint8))
    lens = np.ascontiguousarray(np.asarray(seeds[1], np.int32))
    return (
        strs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(lens), strs, lens,  # keep the arrays alive alongside the ptrs
    )


def encode(data: bytes, params: X3Params = X3Params(), seeds=None,
           warm_tape=None) -> bytes:
    """Reference-format compress on the host CPU.  ``seeds`` is an
    optional (strs u8 [K, 32], lens i32 [K]) seed dictionary — the x3tpu
    broadcast extension (codec.py:_init_shared); the decoder must be
    given the same seeds.  ``warm_tape`` (requires seeds) additionally
    warm-starts the context models from the tape (x3tpu/warm.py)."""
    lib = _load()
    out_ptr = ctypes.POINTER(ctypes.c_uint8)()
    out_size = ctypes.c_size_t()
    if seeds is None:
        assert warm_tape is None, "warm_tape requires seeds"
        rc = lib.x3h_encode(
            data, len(data), params.max_match_count, params.window,
            params.magic_factor1, params.magic_factor2,
            1 if params.nl_remap else 0,
            ctypes.byref(out_ptr), ctypes.byref(out_size),
        )
    elif warm_tape is not None:
        sp, lp, k, _s, _l = _seed_ptrs(seeds)
        tp, tn, _t = _tape_ptr(warm_tape)
        rc = lib.x3h_encode_warm(
            data, len(data), params.max_match_count, params.window,
            params.magic_factor1, params.magic_factor2,
            1 if params.nl_remap else 0, sp, lp, k, tp, tn,
            ctypes.byref(out_ptr), ctypes.byref(out_size),
        )
    else:
        sp, lp, k, _s, _l = _seed_ptrs(seeds)
        rc = lib.x3h_encode_seeded(
            data, len(data), params.max_match_count, params.window,
            params.magic_factor1, params.magic_factor2,
            1 if params.nl_remap else 0, sp, lp, k,
            ctypes.byref(out_ptr), ctypes.byref(out_size),
        )
    if rc != 0:
        raise RuntimeError(f"x3h_encode failed: {rc}")
    return _take(lib, out_ptr, out_size)


def decode(data: bytes, max_output: Optional[int] = None, seeds=None,
           warm_tape=None) -> bytes:
    """Reference-format decompress on the host CPU.

    The format is headerless, so the output size is unknown up front; with
    no explicit ``max_output`` the cap starts at a 64:1 guess (x3.c:621)
    and grows on rc=2 (cap exceeded) until 1 GiB.  ``seeds`` (and
    ``warm_tape``) must match the encoder's (see encode)."""
    lib = _load()
    cap = max_output if max_output is not None else max(64 * len(data), 1 << 20)
    while True:
        out_ptr = ctypes.POINTER(ctypes.c_uint8)()
        out_size = ctypes.c_size_t()
        if seeds is None:
            assert warm_tape is None, "warm_tape requires seeds"
            rc = lib.x3h_decode(
                data, len(data), cap,
                ctypes.byref(out_ptr), ctypes.byref(out_size),
            )
        elif warm_tape is not None:
            sp, lp, k, _s, _l = _seed_ptrs(seeds)
            tp, tn, _t = _tape_ptr(warm_tape)
            rc = lib.x3h_decode_warm(
                data, len(data), cap, sp, lp, k, tp, tn,
                ctypes.byref(out_ptr), ctypes.byref(out_size),
            )
        else:
            sp, lp, k, _s, _l = _seed_ptrs(seeds)
            rc = lib.x3h_decode_seeded(
                data, len(data), cap, sp, lp, k,
                ctypes.byref(out_ptr), ctypes.byref(out_size),
            )
        if rc == 0:
            return _take(lib, out_ptr, out_size)
        if rc == 2 and max_output is None and cap < (1 << 30):
            cap *= 4
            continue
        if rc == 2:
            raise RuntimeError(f"x3h_decode: output exceeds cap {cap}")
        raise RuntimeError("x3h_decode: corrupt stream")


def train_seeds(data: bytes, params: X3Params = X3Params(), k: int = 256,
                ranked: bool = False):
    """Derive a seed dictionary from a sample: k fragments the codec
    learned on it — in insertion order, or (``ranked=True``) by descending
    use count so hot fragments start at low MTF ranks in every seeded
    block.  Returns (strs u8 [n, 32], lens i32 [n]) numpy arrays."""
    import numpy as np

    lib = _load()
    strs = np.zeros((k, 32), np.uint8)
    lens = np.zeros((k,), np.int32)
    fn = lib.x3h_train_ranked if ranked else lib.x3h_train
    n = fn(
        data, len(data), params.max_match_count, params.window,
        params.magic_factor1, params.magic_factor2,
        1 if params.nl_remap else 0,
        strs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        k,
    )
    return strs[:n], lens[:n]


def train_tape(data: bytes, params: X3Params = X3Params(), k: int = 256,
               tape_cap: int = 0):
    """Derive a seed dictionary AND the warm-up tape from a sample
    (x3h_train_tape): usage-ranked seeds plus one tape entry per training
    event — the kept-seed index of the hit tag, or warm.RESET for E_NEW /
    unkept tags.  Returns (strs u8 [n, 32], lens i32 [n], tape list)."""
    import numpy as np

    from x3tpu import warm as warm_mod

    lib = _load()
    strs = np.zeros((k, 32), np.uint8)
    lens = np.zeros((k,), np.int32)
    cap = tape_cap or warm_mod.TAPE_MAX
    tape_arr = np.zeros((cap,), np.int32)
    tape_len = ctypes.c_size_t()
    n = lib.x3h_train_tape(
        data, len(data), params.max_match_count, params.window,
        params.magic_factor1, params.magic_factor2,
        1 if params.nl_remap else 0,
        strs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        k,
        tape_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cap, ctypes.byref(tape_len),
    )
    tape = [warm_mod.RESET if v < 0 else int(v)
            for v in tape_arr[: tape_len.value]]
    return strs[:n], lens[:n], tape


def measure_state(data: bytes, params: X3Params = X3Params(),
                  small_cap: int = 16):
    """Encode on the host and report state growth for capacity tuning:
    dict entries, pairs, ctx0 hub items, max non-hub ctx0 items, ctx1 hub
    items, max non-hub ctx1 items, plus per family the non-hub rows longer
    than ``small_cap`` (CodecCaps.ctx_small_cap) — the rows the device
    codec promotes to big rows, which CodecCaps.ctx_promo_rows must
    cover."""
    lib = _load()
    out = (ctypes.c_int64 * 8)()
    lib.x3h_measure(
        data, len(data), params.max_match_count, params.window,
        params.magic_factor1, params.magic_factor2,
        1 if params.nl_remap else 0, small_cap, out,
    )
    keys = ("dict", "pairs", "ctx0_hub", "ctx0_max", "ctx1_hub",
            "ctx1_max", "ctx0_promoted", "ctx1_promoted")
    return dict(zip(keys, [int(v) for v in out]))
