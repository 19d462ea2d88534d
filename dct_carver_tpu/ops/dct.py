"""Blockwise sliding-window DCT energy — the one energy path on every backend.

Design notes
------------
The reference computes one N×N DCT *per pixel* via scalar C kernels
(`/root/reference/src/dct.c:77-94`, `src/fft2d/shrtdct.c:55`).  Here the same
math is recast as two separable 1-D DCT contractions over sliding windows
(vertical then horizontal), batched over the whole image as multiply-add
chains that XLA fuses — O(N²) MACs per pixel per stage instead of the
reference's per-pixel block transform.

Both the full-image path and the per-seam strip-update path (ops/carve.py)
funnel through ONE inner routine, `energy_from_bands`, so their f32 arithmetic
is identical element-for-element: a recomputed strip is bitwise equal to a
full recompute (asserted in tests/test_carve.py).

DCT conventions (must match the reference exactly — see oracle/reference.py):
  * N in {8,16}: orthonormal DCT-II (src/fft2d/shrtdct.c:190-205).
  * N in {2,4}:  unnormalized case-2 ddct2d (src/fft2d/fftsg2d.c:200-211).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["dct_matrix", "dct_energy_map", "energy_from_bands", "BLOCKSIZES"]

BLOCKSIZES = (2, 4, 8, 16)


@functools.lru_cache(maxsize=None)
def _dct_matrix_np(n: int) -> np.ndarray:
    if n not in BLOCKSIZES:
        raise ValueError(f"blocksize must be one of {BLOCKSIZES}, got {n}")
    j = np.arange(n, dtype=np.float64)
    k = np.arange(n, dtype=np.float64)
    D = np.cos(np.pi * (j[None, :] + 0.5) * k[:, None] / n)
    if n in (8, 16):
        s = np.full(n, math.sqrt(2.0 / n))
        s[0] = math.sqrt(1.0 / n)
        D = D * s[:, None]
    return D


def dct_matrix(n: int, dtype=jnp.float32) -> jax.Array:
    """1-D DCT-II basis (rows = frequency) in the reference's per-size convention."""
    return jnp.asarray(_dct_matrix_np(n), dtype=dtype)


def energy_from_bands(bands: jax.Array, n: int, edges, textures) -> jax.Array:
    """Energy for every sliding window of a per-row vertical band.

    bands: (H, n, C) — for output row i, bands[i, dy, :] is the image row
    i + dy - (r-1) (edge-clamped), r = n//2, over C contiguous columns.
    Output (H, C - n + 1): energy of the window whose LEFT tap starts at each
    column, i.e. output col p is the pixel at band column p + (r-1).

    Semantics (src/dct.c:96-110): max |coefficient| over non-DC atoms with
    last-tie-wins in (kx, ky) row-major scan order (the reference stores the
    block transposed, src/render.c:146-151 — rank = kx*n + ky), weighted by
    `edges` for atoms (0,1)/(1,0) else `textures`.
    """
    H, nb, C = bands.shape
    assert nb == n
    Cout = C - n + 1
    dtype = bands.dtype
    D = _dct_matrix_np(n)  # python-scalar taps keep the chains backend-exact

    # Both DCT stages are explicit multiply-add chains (NOT dot/einsum):
    # elementwise mul/add are exactly-rounded IEEE ops, so the result is
    # bit-determined wherever the compiler does not contract them into FMAs
    # (XLA:GPU does not; docs/PARITY.md).  XLA fuses the whole chain +
    # argmax into a few kernels, so nothing of n^2 size is materialized in
    # device memory.

    # stage 1 — vertical 1-D DCT: V[ky][i, c] = sum_dy D[ky, dy] * bands[i, dy, c]
    V = []
    for ky in range(n):
        v = dtype.type(D[ky, 0]) * bands[:, 0, :]
        for dy in range(1, n):
            v = v + dtype.type(D[ky, dy]) * bands[:, dy, :]
        V.append(v)

    # stage 2 — horizontal sliding DCT + running argmax with the reference's
    # conventions (src/dct.c:96-110): DC excluded, last-tie-wins in
    # rank = kx*n + ky (the block is stored transposed, src/render.c:146-151)
    maxval = jnp.full((H, Cout), -jnp.inf, dtype)
    winner = jnp.full((H, Cout), -1, jnp.int32)
    for ky in range(n):
        sh = [V[ky][:, dx : dx + Cout] for dx in range(n)]
        kx0 = 1 if ky == 0 else 0  # DC atom (0,0) excluded (src/dct.c:103)
        for kx in range(kx0, n):
            t = dtype.type(D[kx, 0]) * sh[0]
            for dx in range(1, n):
                t = t + dtype.type(D[kx, dx]) * sh[dx]
            a = jnp.abs(t)
            rank = kx * n + ky
            take_new = a > maxval
            tie = a == maxval
            winner = jnp.where(
                take_new, rank,
                jnp.where(tie, jnp.maximum(winner, rank), winner),
            )
            maxval = jnp.maximum(maxval, a)

    is_edge = (winner == 1) | (winner == n)  # atoms (0,1),(1,0) (src/dct.c:10-43)
    w = jnp.where(is_edge, jnp.asarray(edges, dtype), jnp.asarray(textures, dtype))
    return maxval * w


def window_offset(n: int, center: str = "carve") -> int:
    """First window offset relative to the pixel (see oracle.window_offset):
    "carve" = liblqr reading window (src/render.c:146-151); "preview" = the
    GUI preview centering (CENTER_ROW/COL, src/dct.h:8-9)."""
    if center == "carve":
        return -(n // 2 - 1)
    if center == "preview":
        return -((n - 1) // 2 - 1)
    raise ValueError(f"center must be 'carve' or 'preview', got {center!r}")


def rows_to_bands(luma: jax.Array, n: int, center: str = "carve") -> jax.Array:
    """(H, W) -> (H, n, W + n - 1): per-output-row vertical band with
    edge-clamped rows and columns (window offsets co..co+n-1)."""
    H, W = luma.shape
    co = window_offset(n, center)
    col_idx = jnp.clip(jnp.arange(W + n - 1) + co, 0, W - 1)
    padded = luma[:, col_idx]  # (H, W+n-1)
    row_idx = jnp.clip(
        jnp.arange(H)[:, None] + co + jnp.arange(n)[None, :], 0, H - 1
    )  # (H, n)
    return padded[row_idx]  # (H, n, W+n-1)


def dct_energy_map(
    luma: jax.Array,
    blocksize: int,
    edges,
    textures,
    *,
    row_block: int | None = None,
    center: str = "carve",
) -> jax.Array:
    """Per-pixel DCT energy of a (H, W) luma plane.  Same contract as
    `oracle.reference.energy_map`; returns (H, W) in `luma.dtype`.

    `row_block`: process rows in chunks of this size to bound peak memory
    (output rows are independent given their bands, so chunking is exact).
    `center`: "carve" (liblqr window) or "preview" (GUI preview centering).
    """
    n = blocksize
    H, W = luma.shape
    bands = rows_to_bands(luma, n, center)
    if row_block is None or row_block >= H:
        return energy_from_bands(bands, n, edges, textures)
    nb = -(-H // row_block)
    pad_h = nb * row_block - H
    bands_p = jnp.pad(bands, ((0, pad_h), (0, 0), (0, 0)))
    chunks = bands_p.reshape(nb, row_block, n, W + n - 1)
    out = jax.lax.map(lambda b: energy_from_bands(b, n, edges, textures), chunks)
    return out.reshape(nb * row_block, W)[:H]
