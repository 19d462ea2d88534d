"""The Carver — lifecycle object mirroring the liblqr carver the plugin drives.

Reference call surface (SURVEY §2.6; `/root/reference/src/render.c:286-325`):
    lqr_carver_new(buffer, w, h, bpp)        -> Carver(image, config)
    lqr_carver_init(carver, 1, 0)            -> (delta_x=1/rigidity=0 built in)
    lqr_carver_set_energy_function(...)      -> config.blocksize/edges/textures
    lqr_carver_set_dump_vmaps                -> vmap is always retained
    lqr_carver_resize(w', h')                -> .resize(w', h')
    lqr_carver_get_energy_image(...)         -> .energy_image()
    lqr_vmap_list_* / lqr_vmap_get_data      -> .visibility_map()
    lqr_carver_scan_line / scan_by_row       -> .output() (whole-array writeback)

Everything device-side runs inside one jitted program per (shape, seam-count)
signature; this object is thin host-side state.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import carve as carve_ops
from ..ops.energy import to_luma, normalize_to_u8
from ..ops.dct import dct_energy_map
from ..utils.config import CarverConfig

__all__ = ["Carver", "CarveResult"]


@functools.partial(
    jax.jit,
    static_argnames=("blocksize", "luma_mode", "row_block", "center",
                     "energy_fn"),
)
def _energy_u8_jit(image, blocksize, edges, textures, luma_mode, row_block,
                   center="carve", energy_fn=None):
    """One fused device program for the energy-image export (outside jit
    every op would be its own dispatch)."""
    plane = to_luma(image, luma_mode)
    if energy_fn is not None:
        e = energy_fn.energy_map(plane, center)
    elif row_block is None:
        from ..ops.carve import full_energy_map

        e = full_energy_map(plane, blocksize, edges, textures, center=center)
    else:
        e = dct_energy_map(plane, blocksize, edges, textures,
                           row_block=row_block, center=center)
    return normalize_to_u8(e)


_to_luma_jit = jax.jit(to_luma, static_argnames=("mode",))


@dataclasses.dataclass
class CarveResult:
    """Outputs of one resize — the analog of render()'s 4 output IDs
    (src/main.c:79-105: image, layer, energy image, seams image)."""
    image: np.ndarray                 # retargeted image (H', W'[, C])
    visibility_map: np.ndarray | None # int32 (H, W) original coords, or None
    energy_image: np.ndarray | None   # u8 normalized first-energy, or None


class Carver:
    """Seam carver over one image.  Width-wise carving is canonical; height
    retargeting transposes internally (liblqr behavior, src/render.c:358-364).
    """

    def __init__(self, image, config: CarverConfig | None = None, *,
                 progress=None, checkpoint_path: str | None = None,
                 checkpoint_every: int = 0, resume_from: str | None = None,
                 **overrides):
        """`progress` is a utils.progress.Progress (the analog of
        lqr_carver_set_progress, src/render.c:316); checkpoint_* / resume_from
        route the seam loop through utils.checkpoint.carve_resumable.  With
        bidirectional resizes they apply to the WIDTH pass (the first one)."""
        if config is None:
            config = CarverConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.progress = progress
        self._ckpt = (checkpoint_path, checkpoint_every, resume_from)
        self.image = np.asarray(image)
        if self.image.ndim not in (2, 3):
            raise ValueError("image must be (H, W) or (H, W, C)")
        self._h, self._w = self.image.shape[:2]

    # -- lqr_carver_get_energy_image (src/render.c:175-202) ------------------
    def energy_image(self, *, vertically: bool | None = None) -> np.ndarray:
        """Full-image energy, min-max normalized to u8 grayscale."""
        cfg = self.config
        img = jnp.asarray(self.image)
        if vertically is None:
            vertically = cfg.vertically
        if vertically:
            img = jnp.swapaxes(img, 0, 1)
        out = _energy_u8_jit(img, cfg.blocksize, cfg.edges, cfg.textures,
                             cfg.luma, cfg.row_block,
                             energy_fn=cfg.energy_function)
        if vertically:
            out = jnp.swapaxes(out, 0, 1)
        return np.asarray(jax.device_get(out))

    # -- dct_energy_preview (src/render.c:421-479): the GUI preview, with its
    #    own BT.601-studio luma (render.h:5) and window centering (dct.h:8-9)
    def energy_preview(self) -> np.ndarray:
        cfg = self.config
        out = _energy_u8_jit(
            jnp.asarray(self.image), cfg.blocksize, cfg.edges, cfg.textures,
            "bt601_studio", cfg.row_block, center="preview",
        )
        return np.asarray(jax.device_get(out))

    # -- lqr_carver_resize (src/render.c:377) ---------------------------------
    def resize(self, new_width: int, new_height: int) -> CarveResult:
        """Retarget to (new_width, new_height).  Like liblqr, the width pass
        runs first, then the height pass on the result (bidirectional carving).
        """
        result_img = self.image
        vmap = None
        energy = None
        if new_width != self._w:
            result_img, vmap, energy = self._carve_axis(
                result_img, new_width - self._w, transpose=False
            )
        if new_height != self._h:
            result_img, vmap2, energy2 = self._carve_axis(
                result_img, new_height - self._h, transpose=True
            )
            if vmap is None:
                vmap, energy = vmap2, energy2
        if not self.config.resize_canvas:
            # src/main.h:19 resize_canvas=FALSE: keep the original canvas —
            # the retargeted layer sits at the top-left (a GIMP layer offset
            # of 0,0); shrunk dimensions zero-fill, grown ones crop
            canvas = np.zeros((self._h, self._w) + result_img.shape[2:],
                              result_img.dtype)
            h = min(self._h, result_img.shape[0])
            w = min(self._w, result_img.shape[1])
            canvas[:h, :w] = result_img[:h, :w]
            result_img = canvas
        return CarveResult(
            image=result_img,
            visibility_map=vmap if self.config.output_seams else None,
            energy_image=energy if self.config.output_energy else None,
        )

    def _resolved_parallel(self) -> str:
        """The effective execution route for THIS carver (one image)."""
        par = self.config.parallel
        if par == "batch":
            raise ValueError(
                "parallel='batch' applies to image stacks — pass a "
                "(B, H, W[, C]) array to api.carve, or use "
                "parallel.mesh.carve_batch")
        if par == "auto":
            par = "spatial" if len(jax.devices()) > 1 else "none"
        return par

    # -- the single-axis carve (vertical seams over a possibly-transposed img)
    def _carve_axis(self, image: np.ndarray, delta: int, transpose: bool):
        cfg = self.config
        img = np.swapaxes(image, 0, 1) if transpose else image
        n = abs(delta)
        if n >= img.shape[1]:
            raise ValueError(
                f"cannot change dimension by {delta}: image is {img.shape[1]} wide"
            )
        if self._resolved_parallel() == "spatial":
            return self._carve_axis_spatial(img, delta, transpose)
        dev_img = jnp.asarray(img)
        luma = _to_luma_jit(dev_img, mode=cfg.luma)
        ckpt_path, ckpt_every, resume = self._ckpt
        if transpose or (self.progress is None and ckpt_path is None
                         and resume is None):
            state = carve_ops.carve_n_seams(
                luma, n, cfg.blocksize, cfg.edges, cfg.textures,
                strip_update=cfg.strip_update,
                delta_x=cfg.delta_x, rigidity=cfg.rigidity,
                energy_fn=cfg.energy_function, tie=cfg.tie,
            )
        else:
            from ..utils.checkpoint import carve_resumable

            state = carve_resumable(
                luma, n, cfg, checkpoint_path=ckpt_path,
                checkpoint_every=ckpt_every, resume_from=resume,
                progress=self.progress,
            )
        vmap = state.vmap
        if delta < 0:
            out = carve_ops.reconstruct_removed(dev_img, vmap, n)
        else:
            out = carve_ops.reconstruct_enlarged(dev_img, vmap, n)
        out = np.asarray(jax.device_get(out))
        vmap_np = np.asarray(jax.device_get(vmap))
        energy_np = None
        if cfg.output_energy:
            # the reference exports the PRE-carve energy (display_carver_energy
            # runs before lqr_carver_resize, src/render.c:370-377)
            energy_np = np.asarray(jax.device_get(_energy_u8_jit(
                dev_img, cfg.blocksize, cfg.edges, cfg.textures,
                cfg.luma, cfg.row_block, energy_fn=cfg.energy_function,
            )))
        if transpose:
            out = np.swapaxes(out, 0, 1)
            vmap_np = np.swapaxes(vmap_np, 0, 1)
            if energy_np is not None:
                energy_np = np.swapaxes(energy_np, 0, 1)
        return out, vmap_np, energy_np

    # -- the mesh-sharded single-image route (parallel.spatial — the same
    #    seams as the single-device path, asserted in tests/test_api.py)
    def _carve_axis_spatial(self, img: np.ndarray, delta: int,
                            transpose: bool):
        from ..parallel.spatial import (spatial_carve_n_seams,
                                        spatial_enlarge_n_seams)

        cfg = self.config
        n = abs(delta)
        dev_img = jnp.asarray(img)
        luma = _to_luma_jit(dev_img, mode=cfg.luma)
        ckpt_path, ckpt_every, resume = self._ckpt
        if transpose:  # like the single-device path, ckpt/progress cover the
            ckpt_path = resume = None  # width pass (the first) only
        common = dict(
            blocksize=cfg.blocksize, edges=cfg.edges, textures=cfg.textures,
            strip_update=cfg.strip_update,
            delta_x=cfg.delta_x, rigidity=cfg.rigidity,
            energy=cfg.energy_function, tie=cfg.tie,
            progress=None if transpose else self.progress,
            chunk=ckpt_every if (ckpt_path or resume) else 0,
            checkpoint_dir=ckpt_path, resume_from=resume,
        )
        if delta < 0:
            res = spatial_carve_n_seams(luma, n, image=dev_img, **common)
            out = np.asarray(jax.device_get(res.image))[:, : img.shape[1] - n]
        else:
            res = spatial_enlarge_n_seams(luma, n, dev_img, **common)
            out = np.asarray(jax.device_get(res.image))
        vmap_np = np.asarray(jax.device_get(res.vmap))
        energy_np = None
        if cfg.output_energy:
            # pre-carve energy export, same semantics as the single-device
            # route (display_carver_energy runs before the resize,
            # src/render.c:370-377)
            energy_np = np.asarray(jax.device_get(_energy_u8_jit(
                dev_img, cfg.blocksize, cfg.edges, cfg.textures,
                cfg.luma, cfg.row_block, energy_fn=cfg.energy_function,
            )))
        if transpose:
            out = np.swapaxes(out, 0, 1)
            vmap_np = np.swapaxes(vmap_np, 0, 1)
            if energy_np is not None:
                energy_np = np.swapaxes(energy_np, 0, 1)
        return out, vmap_np, energy_np
