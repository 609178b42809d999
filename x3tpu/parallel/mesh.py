"""Device-mesh construction and sharded codec execution.

Each device runs its own lockstep event loop over its local lanes via
``shard_map`` — lanes on different devices never synchronize (no global
``jnp.any`` reduction across the mesh), so per-device loops exit as soon as
their local blocks finish.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map as _shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from x3tpu import codec
from x3tpu.config import CodecCaps, X3Params

AXIS = "blocks"


def make_mesh(num_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 1-D mesh over the block-parallel axis.  Blocks never talk to each
    other, so the mesh follows the algorithm alone: on one host every card
    reaches every other over NVLink at the same rate."""
    if devices is None:
        devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (AXIS,))


def _spec_like(tree, spec):
    return jax.tree.map(lambda _: spec, tree)


def _sharded(fn, mesh, in_specs, args):
    """shard_map ``fn`` with every output sharded over AXIS."""
    out_shape = jax.eval_shape(fn, *args)
    sm = _shard_map(
        fn,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=_spec_like(out_shape, P(AXIS)),
        check_vma=False,
    )
    return sm(*args)


@functools.partial(
    jax.jit, static_argnames=("params", "caps", "mesh_holder", "has_seeds")
)
def _enc_init_sharded(text, tlen, seeds, params, caps, mesh_holder,
                      has_seeds=False):
    mesh = mesh_holder.mesh
    if has_seeds:
        fn = lambda t, l, s0, s1: codec.enc_init_carry(
            t, l, params, caps, seeds=(s0, s1)
        )
        return _sharded(fn, mesh, (P(AXIS), P(AXIS), P(), P()),
                        (text, tlen, seeds[0], seeds[1]))
    fn = lambda t, l: codec.enc_init_carry(t, l, params, caps)
    return _sharded(fn, mesh, (P(AXIS), P(AXIS)), (text, tlen))


@functools.partial(
    jax.jit, static_argnames=("params", "nsteps", "mesh_holder"),
    donate_argnums=(0,),
)
def _enc_chunk_sharded(carry, params, nsteps, mesh_holder):
    fn = lambda c: codec.enc_chunk(c, params, nsteps)
    specs = _spec_like(carry, P(AXIS))
    return _sharded(fn, mesh_holder.mesh, (specs,), (carry,))


@functools.partial(jax.jit, static_argnames=("mesh_holder",))
def _enc_finalize_sharded(carry, mesh_holder):
    specs = _spec_like(carry, P(AXIS))
    return _sharded(codec.enc_finalize, mesh_holder.mesh, (specs,), (carry,))


@functools.partial(
    jax.jit, static_argnames=("params", "caps", "mesh_holder", "has_seeds")
)
def _dec_init_sharded(words, byte_lens, seeds, params, caps, mesh_holder,
                      has_seeds=False):
    mesh = mesh_holder.mesh
    if has_seeds:
        fn = lambda w, b, s0, s1: codec.dec_init_carry(
            w, b, params, caps, seeds=(s0, s1)
        )
        return _sharded(fn, mesh, (P(AXIS), P(AXIS), P(), P()),
                        (words, byte_lens, seeds[0], seeds[1]))
    fn = lambda w, b: codec.dec_init_carry(w, b, params, caps)
    return _sharded(fn, mesh, (P(AXIS), P(AXIS)), (words, byte_lens))


@functools.partial(
    jax.jit, static_argnames=("params", "nsteps", "mesh_holder"),
    donate_argnums=(0,),
)
def _dec_chunk_sharded(carry, params, nsteps, mesh_holder):
    fn = lambda c: codec.dec_chunk(c, params, nsteps)
    specs = _spec_like(carry, P(AXIS))
    return _sharded(fn, mesh_holder.mesh, (specs,), (carry,))


@functools.partial(jax.jit, static_argnames=("mesh_holder",))
def _dec_finalize_sharded(carry, mesh_holder):
    specs = _spec_like(carry, P(AXIS))
    return _sharded(codec.dec_finalize, mesh_holder.mesh, (specs,), (carry,))


class MeshHolder:
    """Hashable wrapper so a Mesh can ride through jit static args."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __hash__(self):
        return hash(tuple(d.id for d in self.mesh.devices.flat))

    def __eq__(self, other):
        return (
            isinstance(other, MeshHolder)
            and tuple(d.id for d in self.mesh.devices.flat)
            == tuple(d.id for d in other.mesh.devices.flat)
        )


def encode_sharded(text, tlen, params: X3Params, caps: CodecCaps, mesh: Mesh,
                   seeds=None, chunk_steps: int = 8192):
    """Chunked sharded encode: lanes sharded over the mesh, the host
    looping bounded chunk programs (each device execution covers at most
    ``chunk_steps`` events; the chunk boundaries are the run's progress
    points, where the host checks whether any lane is still active).  The
    lane count must be a multiple of the mesh size; seeds (if any) are
    broadcast replicated to every device."""
    sharding = NamedSharding(mesh, P(AXIS))
    text = jax.device_put(text, sharding)
    tlen = jax.device_put(tlen, sharding)
    mh = MeshHolder(mesh)
    carry = _enc_init_sharded(
        text, tlen, seeds, params, caps, mh, has_seeds=seeds is not None
    )
    while bool(codec._enc_active_jit(carry)):
        carry = _enc_chunk_sharded(carry, params, chunk_steps, mh)
    return _enc_finalize_sharded(carry, mh)


def decode_sharded(words, byte_lens, params: X3Params, caps: CodecCaps,
                   mesh: Mesh, seeds=None, chunk_steps: int = 8192):
    """Chunked sharded decode (see :func:`encode_sharded`)."""
    sharding = NamedSharding(mesh, P(AXIS))
    words = jax.device_put(words, sharding)
    byte_lens = jax.device_put(byte_lens, sharding)
    mh = MeshHolder(mesh)
    carry = _dec_init_sharded(
        words, byte_lens, seeds, params, caps, mh, has_seeds=seeds is not None
    )
    while bool(codec._dec_active_jit(carry)):
        carry = _dec_chunk_sharded(carry, params, chunk_steps, mh)
    return _dec_finalize_sharded(carry, mh)
