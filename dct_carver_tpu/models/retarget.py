"""Precompute-once / slide-many retargeting — the interactive-dialog capability
(`/root/reference/src/interface.c:37-154`): liblqr computes ±N seams once
(`interface.c:131-135`), then any width within the range is a cheap replay
(`callback_resize_slider`, `interface.c:647-670`).

Equivalent here: carve N seams once to get the ordered visibility map;
"sliding" to width w0−s (or w0+s) is then a single gather/scatter from the
original image using `vmap <= s` — O(H·W) with no DP, jitted once for all s
(dynamic s, static shapes: outputs keep buffer width, the logical width is
returned alongside and sliced on host).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import carve as carve_ops
from ..ops.energy import to_luma
from ..utils.config import CarverConfig

__all__ = ["InteractiveRetargeter"]


@functools.partial(jax.jit, static_argnames=())
def _slide_removed(image: jax.Array, vmap: jax.Array, s: jax.Array) -> jax.Array:
    """Apply the first `s` removal seams; result padded to buffer width."""
    H, W = image.shape[:2]
    removed = (vmap > 0) & (vmap <= s)
    order = jnp.argsort(removed, axis=1, stable=True)
    idx = order[..., None] if image.ndim == 3 else order
    return jnp.take_along_axis(image, idx, axis=1)


class InteractiveRetargeter:
    """Precompute ±`max_seams` once; then `at_width(w)` / `at_height(h)` are
    gather-only (the `interface.c:647-670` slider semantics)."""

    def __init__(self, image, max_seams: int, config: CarverConfig | None = None,
                 vertical: bool = False, **overrides):
        import dataclasses
        if config is None:
            config = CarverConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.vertical = vertical
        img = np.asarray(image)
        if vertical:
            img = np.swapaxes(img, 0, 1)
        self._img = jnp.asarray(img)
        self._h, self._w = img.shape[:2]
        self.max_seams = int(max_seams)
        if self.max_seams >= self._w:
            raise ValueError("max_seams must be < width")

        from .carver import _to_luma_jit

        luma = _to_luma_jit(self._img, mode=config.luma)
        state = carve_ops.carve_n_seams(
            luma, self.max_seams, config.blocksize, config.edges,
            config.textures, strip_update=config.strip_update,
            delta_x=config.delta_x, rigidity=config.rigidity,
            energy_fn=config.energy_function, tie=config.tie,
        )
        self._vmap = state.vmap  # ordered seams, original coordinates

    @property
    def visibility_map(self) -> np.ndarray:
        return np.asarray(self._vmap)

    def at_width(self, new_width: int) -> np.ndarray:
        """Retargeted image at any width in [w0-max_seams, w0+max_seams]."""
        s = new_width - self._w
        if abs(s) > self.max_seams:
            raise ValueError(
                f"width {new_width} outside precomputed range "
                f"±{self.max_seams} of {self._w}"
            )
        if s == 0:
            out = np.asarray(self._img)
        elif s < 0:
            padded = _slide_removed(self._img, self._vmap, jnp.int32(-s))
            out = np.asarray(padded)[:, :new_width]
        else:
            # masked vmap: only the first s seams insert
            vm = jnp.where(self._vmap <= s, self._vmap, 0)
            full = carve_ops.reconstruct_enlarged(self._img, vm, s)
            out = np.asarray(full)
        if self.vertical:
            out = np.swapaxes(out, 0, 1)
        return out

    def at_delta(self, s: int) -> np.ndarray:
        return self.at_width(self._w + s)
