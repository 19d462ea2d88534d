"""Batch-parallel carving over a device mesh (SURVEY §2 parallelism table).

The reference processes one image per plugin invocation (`render()`,
src/render.c:327); per-image independence makes batch the outermost, trivially
shardable axis.  `vmap` the whole static-shape carve loop over a batch and
shard the batch axis over the mesh with `NamedSharding` — XLA partitions the
program with zero collectives (per-image independence preserved end to end).
Under `vmap` the seam-DP kernel runs one program per image.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import carve as carve_ops
from ..ops.energy import to_luma

__all__ = ["make_mesh", "carve_batch", "batch_carve_states"]


def make_mesh(n_devices: int | None = None, axis_name: str = "data") -> Mesh:
    """1-D device mesh over the first `n_devices` devices (default: all)."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


@functools.partial(
    jax.jit,
    static_argnames=("n_seams", "blocksize", "strip_update", "luma_mode",
                     "energy_fn", "delta_x", "rigidity", "tie"),
)
def batch_carve_states(
    images: jax.Array,
    n_seams: int,
    blocksize: int,
    edges,
    textures,
    strip_update: bool = True,
    luma_mode: str = "bt709",
    energy_fn=None,
    delta_x: int = 1,
    rigidity: float = 0.0,
    tie: str = "leftmost",
):
    """vmap'ed carve over a batch of identically-shaped images (B,H,W[,C]).

    Returns the batched CarveState.  Shard the batch axis with NamedSharding
    on the inputs (see `carve_batch`) for multi-chip execution.
    """
    lumas = jax.vmap(lambda im: to_luma(im, luma_mode))(images)
    return jax.vmap(
        lambda l: carve_ops.carve_n_seams(
            l, n_seams, blocksize, edges, textures, strip_update=strip_update,
            energy_fn=energy_fn, delta_x=delta_x, rigidity=rigidity, tie=tie,
        )
    )(lumas)


def carve_batch(
    images,
    n_seams: int,
    *,
    blocksize: int = 8,
    edges: float = 0.0,
    textures: float = 1.0,
    mesh: Mesh | None = None,
    strip_update: bool = True,
    reconstruct: bool = True,
    energy=None,
    luma: str = "bt709",
    delta_x: int = 1,
    rigidity: float = 0.0,
    tie: str = "leftmost",
):
    """Remove `n_seams` vertical seams from every image in a batch, data-parallel
    over `mesh` (config 4 of BASELINE.md: 1024 × 1-Mpix images, 128 seams).

    images: (B, H, W[, C]) u8/float.  Returns (carved_images | None, vmaps).
    """
    if mesh is None:
        mesh = make_mesh()
    axis = mesh.axis_names[0]
    nd = mesh.shape[axis]
    images = jnp.asarray(images)
    B = images.shape[0]
    # pad the batch to a multiple of the mesh size (repeat the last image)
    pad = (-B) % nd
    if pad:
        images = jnp.concatenate(
            [images, jnp.repeat(images[-1:], pad, axis=0)], axis=0
        )
    sharding = NamedSharding(mesh, P(axis))
    images = jax.device_put(images, sharding)

    from ..ops.energy_fn import resolve_energy

    states = batch_carve_states(
        images, n_seams, blocksize, edges, textures, strip_update,
        luma_mode=luma, energy_fn=resolve_energy(energy),
        delta_x=delta_x, rigidity=rigidity, tie=tie,
    )
    if not reconstruct:
        return None, states.vmap[:B]
    out = jax.jit(
        jax.vmap(lambda im, vm: carve_ops.reconstruct_removed(im, vm, n_seams))
    )(images, states.vmap)
    return out[:B], states.vmap[:B]
