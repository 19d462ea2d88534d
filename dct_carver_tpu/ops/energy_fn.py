"""Pluggable per-pixel energy functions — the carving engine's
`lqr_carver_set_energy_function` surface, vectorized.

Reference: liblqr lets the host plug ANY per-pixel energy callback into the
carver; the callback reads an edge-clamped window around the pixel through a
reading-window handle (`lqr_carver_set_energy_function` at
/root/reference/src/render.c:314-315, window reads via `lqr_rwindow_read` at
/root/reference/src/render.c:144-151).  The dct-carver plugin plugs its DCT
energy in this way; liblqr also ships builtin gradient energies the host can
select instead.

Design: instead of a scalar per-pixel callback (one host call per
pixel — the reference's dominant cost), an energy function here is a
*vectorized* function over per-row vertical bands, the same internal layout
the DCT path uses (ops/dct.py `rows_to_bands`): for output row i,
``bands[i, dy, :]`` is image row ``clip(i + dy - (r-1))`` over contiguous
columns, ``r = n // 2``.  The function returns the energy of every sliding
window at once, so it vectorizes over the whole image AND over the per-seam
update strips — custom energies get the same incremental strip updates (and
the same bitwise strip == full guarantee) as the builtin DCT energy.

Window correspondence with the reference's reading window
(/root/reference/src/render.c:146-151): for pixel (i, j), tap (y, x) with
x, y in -r+1 .. r is ``bands[i, y + r - 1, j + x + r - 1]`` — i.e.
``lqr_rwindow_read(rw, x, y)`` == ``window[y + r - 1, x + r - 1]`` for the
(n, n) window handed to `custom_energy` block functions.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

__all__ = [
    "EnergyFunction", "custom_energy", "builtin_energy", "resolve_energy",
    "GRAD_XABS", "GRAD_SUMABS", "GRAD_NORM", "ENERGY_NULL", "BUILTIN_ENERGIES",
]


class EnergyFunction(NamedTuple):
    """A pluggable energy: window size `n` (even; radius = n//2, the liblqr
    `radius` argument) and a vectorized `bands_fn`.

    bands_fn: (B, n, C) bands -> (B, C - n + 1) energies, where output column
    p is the energy of the pixel whose window occupies band columns
    p .. p+n-1.  Must be pure, shape-polymorphic in (B, C), and depend only on
    the window (locality is what makes strip updates exact).  Instances are
    hashable (jit-static); reuse one instance across calls to share compile
    caches.
    """
    name: str
    n: int
    bands_fn: Callable[[jax.Array], jax.Array]

    @property
    def radius(self) -> int:
        return self.n // 2

    def energy_map(self, luma: jax.Array, center: str = "carve") -> jax.Array:
        """Full-image energy of a (H, W) plane (edge-clamped windows)."""
        from .dct import rows_to_bands

        return self.bands_fn(rows_to_bands(luma, self.n, center))


def _validated(fn: EnergyFunction) -> EnergyFunction:
    if fn.n < 2 or fn.n % 2:
        raise ValueError(f"energy window size must be even and >= 2, got {fn.n}")
    return fn


def custom_energy(radius: int, block_fn: Callable[[jax.Array], jax.Array],
                  name: str = "custom") -> EnergyFunction:
    """Energy from a per-window function — the closest analog of the
    reference's per-pixel callback + reading window (src/render.c:134-157).

    block_fn: (n, n) window -> scalar energy, n = 2 * radius; window[dy, dx]
    is the edge-clamped pixel at offset (dy - (r-1), dx - (r-1)) from the
    center (the exact tap set liblqr's rwindow exposes at this radius,
    src/render.c:146-147).  It is vmapped over all windows; write it in plain
    jax.numpy.  For peak throughput prefer a hand-vectorized EnergyFunction
    (see GRAD_* below or the DCT path) — this wrapper materializes the (n, n)
    window stack.
    """
    if radius < 1:
        raise ValueError(f"radius must be >= 1, got {radius}")
    n = 2 * radius

    def bands_fn(bands: jax.Array) -> jax.Array:
        B, nn, C = bands.shape
        assert nn == n, (nn, n)
        Cout = C - n + 1
        # (B, n, Cout, n): [b, dy, p, dx] — window p spans band cols p..p+n-1
        wins = jnp.stack([bands[:, :, dx:dx + Cout] for dx in range(n)],
                         axis=-1)
        wins = jnp.moveaxis(wins, 2, 1)  # (B, Cout, n, n) [b, p, dy, dx]
        return jax.vmap(jax.vmap(block_fn))(wins)

    return _validated(EnergyFunction(name, n, bands_fn))


# --------------------------------------------------------------- builtins --
# liblqr-style builtin gradient energies (the library's non-custom options).
# All use a 2x2 window (radius 1): with carve centering the taps sit at
# offsets {0, +1} in both dims, so dx/dy are forward differences with the
# edge-clamped border giving 0 at the last column/row.

def _forward_diffs(bands: jax.Array):
    x = bands[:, 0, :-1]
    dx = bands[:, 0, 1:] - x   # right neighbor - pixel
    dy = bands[:, 1, :-1] - x  # down neighbor - pixel
    return dx, dy


def _grad_xabs(bands):
    dx, _ = _forward_diffs(bands)
    return jnp.abs(dx)


def _grad_sumabs(bands):
    dx, dy = _forward_diffs(bands)
    return (jnp.abs(dx) + jnp.abs(dy)) * bands.dtype.type(0.5)


def _grad_norm(bands):
    dx, dy = _forward_diffs(bands)
    return jnp.sqrt(dx * dx + dy * dy)


def _null(bands):
    return jnp.zeros_like(bands[:, 0, :-1])


GRAD_XABS = EnergyFunction("grad_xabs", 2, _grad_xabs)
GRAD_SUMABS = EnergyFunction("grad_sumabs", 2, _grad_sumabs)
GRAD_NORM = EnergyFunction("grad_norm", 2, _grad_norm)
ENERGY_NULL = EnergyFunction("null", 2, _null)

BUILTIN_ENERGIES = {
    fn.name: fn for fn in (GRAD_XABS, GRAD_SUMABS, GRAD_NORM, ENERGY_NULL)
}


def builtin_energy(name: str) -> EnergyFunction:
    try:
        return BUILTIN_ENERGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown builtin energy {name!r}; options: "
            f"{sorted(BUILTIN_ENERGIES)} (or 'dct' via energy_fn=None)"
        ) from None


def resolve_energy(energy) -> EnergyFunction | None:
    """None / 'dct' -> None (the default DCT path); a builtin name or an
    EnergyFunction passes through."""
    if energy is None or energy == "dct":
        return None
    if isinstance(energy, EnergyFunction):
        return _validated(energy)
    if isinstance(energy, str):
        return builtin_energy(energy)
    raise TypeError(f"energy must be None, a name, or an EnergyFunction; "
                    f"got {type(energy).__name__}")
