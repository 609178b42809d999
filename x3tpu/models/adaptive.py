"""Lane-parallel adaptive frequency models (ac.c:200-273).

A model is a freq vector [L, M] (+ optional live count for the growing
order-0 index model).  The reference's per-update cumulative-frequency
rebuild (count_cum_freqs, ac.c:6-18) disappears: coding computes the three
masked reductions (low_f, span, total) directly, and decoding uses one
vector cumsum — both O(M) lane-wide ops.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

I32 = jnp.int32


def model_encode_stats(
    freqs: jax.Array, sym: jax.Array, count: Optional[jax.Array] = None
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """(low_f, span, total) for coding ``sym`` [L] from ``freqs`` [L, M].
    Frequencies at positions >= count must be zero (maintained by inc/grow)."""
    lanes, M = freqs.shape
    lane = jnp.arange(lanes, dtype=I32)
    iota = jnp.arange(M, dtype=I32)[None, :]
    low = jnp.sum(jnp.where(iota < sym[:, None], freqs, 0), axis=1)
    span = freqs[lane, jnp.minimum(sym, M - 1)]
    total = jnp.sum(freqs, axis=1)
    return low, span, total


def model_decode_sym(
    freqs: jax.Array, value: jax.Array, count: Optional[jax.Array] = None
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Find the symbol whose interval contains ``value`` (u32 [L]).
    Returns (sym, low_f, span)."""
    lanes, M = freqs.shape
    lane = jnp.arange(lanes, dtype=I32)
    iota = jnp.arange(M, dtype=I32)[None, :]
    valid = (iota < count[:, None]) if count is not None else (freqs > 0)
    cum = jnp.cumsum(freqs, axis=1) - freqs  # exclusive prefix
    le = valid & (cum.astype(jnp.uint32) <= value[:, None])
    sym = jnp.maximum(jnp.sum(le, axis=1).astype(I32) - 1, 0)
    low = cum[lane, sym]
    span = freqs[lane, sym]
    return sym, low, span


def model_inc(freqs: jax.Array, sym: jax.Array, active: jax.Array) -> jax.Array:
    """freq[sym] += 1 per active lane (inc_model, ac.c:215-228)."""
    lanes, M = freqs.shape
    lane = jnp.arange(lanes, dtype=I32)
    s = jnp.minimum(sym, M - 1)
    return freqs.at[lane, s].add(jnp.where(active, 1, 0).astype(freqs.dtype))


def f32_prob(span: jax.Array, total: jax.Array) -> jax.Array:
    """f32 probability estimate matching C float semantics
    ((float)freq / total, ac.c:108-113): the correctly rounded f32
    quotient of the two operands rounded to f32.

    The encoder picks its coding mode by comparing products of these
    quotients (codec._hit_mode_stats), so one last-bit difference changes
    the stream.  Hardware f32 division is not correctly rounded on every
    backend (XLA's GPU code uses a 2-ulp divide), so the quotient is built
    from exact u32 integer division instead: a 25/26-bit quotient of the
    24-bit mantissas, then round-to-nearest-even.  Operands are
    non-negative; ``total`` >= 1 at every call site (a zero total falls
    back to the hardware divide)."""
    a = span.astype(jnp.float32)
    b = total.astype(jnp.float32)
    ab = jax.lax.bitcast_convert_type(a, jnp.uint32)
    bb = jax.lax.bitcast_convert_type(b, jnp.uint32)
    ma = (ab & 0x7FFFFF) | 0x800000                  # 24-bit mantissas
    mb = (bb & 0x7FFFFF) | 0x800000
    # floor(ma * 2^25 / mb) by long division in 7/7/7/4-bit digits: every
    # partial numerator stays below 2^31
    q = jnp.zeros_like(ma)
    r = ma
    for shift in (7, 7, 7, 4):
        n = r << shift
        q = (q << shift) | (n // mb)
        r = n % mb
    big = q >= (1 << 25)                             # ma >= mb: 26 bits
    mant = jnp.where(big, q >> 2, q >> 1)
    guard = jnp.where(big, q >> 1, q) & 1
    sticky = (r != 0) | (big & ((q & 1) != 0))
    mant = mant + (guard & (sticky | ((mant & 1) != 0)).astype(jnp.uint32))
    carry = mant >> 24                               # rounded up to 2^24
    mant = jnp.where(carry != 0, mant >> 1, mant)
    exp = ((ab >> 23).astype(I32) - (bb >> 23).astype(I32) + 127
           - jnp.where(big, 0, 1) + carry.astype(I32))
    bits = (exp.astype(jnp.uint32) << 23) | (mant & 0x7FFFFF)
    q32 = jax.lax.bitcast_convert_type(bits, jnp.float32)
    q32 = jnp.where(ab == 0, jnp.float32(0), q32)
    return jnp.where(bb == 0, a / b, q32)
