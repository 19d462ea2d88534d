"""Top-level one-call API — the analog of the plugin's render() entry point
(`/root/reference/src/render.c:327-419` / PDB procedure `src/main.c:79-105`).
"""

from __future__ import annotations

import functools

import numpy as np

from .models.carver import Carver, CarveResult
from .utils.config import CarverConfig

__all__ = ["carve", "CarveResult", "CarverConfig"]


def carve(
    image,
    seams_number: int,
    *,
    blocksize: int = 8,
    edges: float = 0.0,
    textures: float = 1.0,
    vertically: bool = False,
    output_energy: bool = False,
    output_seams: bool = False,
    **framework_knobs,
) -> CarveResult:
    """Retarget `image` by `seams_number` seams (signed: <0 removes, >0 inserts;
    `vertically=True` changes the HEIGHT — src/render.c:358-364 semantics).

    Defaults mirror the plugin's (src/main.c:30-40).

    Execution routing (`parallel=` framework knob, CarverConfig.parallel):
    "spatial" column-shards ONE image over the device mesh; "batch"
    data-parallels an image STACK — pass a (B, H, W[, C]) array and the
    result fields come back stacked over B; "auto" picks spatial with >1
    device (batch for 4-D inputs).  Seams are route-independent, and every
    knob (tie, energy, resize_canvas, output_energy/seams, ...) is honored
    on every route.
    """
    image = np.asarray(image)
    cfg = CarverConfig(
        edges=edges, textures=textures, blocksize=blocksize,
        seams_number=seams_number, vertically=vertically,
        output_energy=output_energy, output_seams=output_seams,
        **framework_knobs,
    )
    if cfg.parallel == "batch" or (cfg.parallel == "auto" and image.ndim == 4):
        return _carve_stack(image, seams_number, cfg)
    carver = Carver(image, cfg)
    h, w = image.shape[:2]
    if seams_number == 0:
        return CarveResult(
            image=image.copy(),
            visibility_map=(np.zeros((h, w), np.int32) if output_seams else None),
            energy_image=(carver.energy_image() if output_energy else None),
        )
    if vertically:
        return carver.resize(w, h + seams_number)
    return carver.resize(w + seams_number, h)


@functools.cache
def _batch_jits():
    """Module-level jitted helpers for the batch route (cached so repeated
    carve() calls with the same shapes hit the trace cache instead of
    re-tracing through a throwaway lambda)."""
    import jax

    from .ops.carve import full_energy_map, reconstruct_enlarged
    from .ops.energy import normalize_to_u8, to_luma

    @functools.partial(jax.jit, static_argnames=("n",))
    def enlarge(images, vmaps, n):
        return jax.vmap(
            lambda im, vm: reconstruct_enlarged(im, vm, n))(images, vmaps)

    @functools.partial(
        jax.jit, static_argnames=("blocksize", "luma_mode", "energy_fn"))
    def energy_u8(images, blocksize, edges, textures, luma_mode, energy_fn):
        def one(im):
            plane = to_luma(im, luma_mode)
            e = full_energy_map(plane, blocksize, edges, textures,
                                energy_fn=energy_fn)
            return normalize_to_u8(e)  # per-image min-max, like the single route

        return jax.vmap(one)(images)

    return enlarge, energy_u8


def _carve_stack(images: np.ndarray, seams_number: int,
                 cfg: CarverConfig) -> CarveResult:
    """Data-parallel carve of a (B, H, W[, C]) stack (parallel.mesh —
    BASELINE config 4).  Every image is carved independently, exactly as
    `render()` treats each invocation (src/render.c:327); results stack
    over B and every CarverConfig knob keeps its single-image meaning."""
    import jax
    import jax.numpy as jnp

    from .parallel.mesh import carve_batch

    if images.ndim not in (3, 4):
        raise ValueError(
            f"parallel='batch' needs a (B, H, W[, C]) stack; got shape "
            f"{images.shape}")
    if seams_number == 0:
        B, h, w = images.shape[:3]
        return CarveResult(
            image=images.copy(),
            visibility_map=(np.zeros((B, h, w), np.int32)
                            if cfg.output_seams else None),
            energy_image=None,
        )
    if cfg.vertically:
        images = np.swapaxes(images, 1, 2)
    B, h0, w0 = images.shape[:3]
    n = abs(seams_number)
    if n >= w0:
        raise ValueError(
            f"cannot change dimension by {seams_number}: images are "
            f"{w0} wide")
    enlarge_jit, energy_jit = _batch_jits()
    energy = None
    if cfg.output_energy:
        # pre-carve energy export, per image (src/render.c:370-377 ordering)
        energy = np.asarray(jax.device_get(energy_jit(
            jnp.asarray(images), cfg.blocksize, cfg.edges, cfg.textures,
            cfg.luma, cfg.energy_function)))
    kw = dict(
        blocksize=cfg.blocksize, edges=cfg.edges, textures=cfg.textures,
        strip_update=cfg.strip_update, energy=cfg.energy_function,
        luma=cfg.luma, delta_x=cfg.delta_x, rigidity=cfg.rigidity,
        tie=cfg.tie,
    )
    if seams_number < 0:
        out, vmaps = carve_batch(images, n, **kw)
    else:
        _, vmaps = carve_batch(images, n, reconstruct=False, **kw)
        out = enlarge_jit(jnp.asarray(images), vmaps, n)
    out = np.asarray(jax.device_get(out))
    vmaps = np.asarray(jax.device_get(vmaps))
    if not cfg.resize_canvas:
        # resize_canvas=FALSE analog (src/main.h:19), per image: removals
        # zero-fill the vacated region on the original canvas, enlargements
        # crop — identical semantics to the single-image route
        canvas = np.zeros((B, h0, w0) + out.shape[3:], out.dtype)
        w = min(w0, out.shape[2])
        canvas[:, :, :w] = out[:, :, :w]
        out = canvas
    if cfg.vertically:
        out = np.swapaxes(out, 1, 2)
        vmaps = np.swapaxes(vmaps, 1, 2)
        if energy is not None:
            energy = np.swapaxes(energy, 1, 2)
    return CarveResult(
        image=out,
        visibility_map=vmaps if cfg.output_seams else None,
        energy_image=energy,
    )
