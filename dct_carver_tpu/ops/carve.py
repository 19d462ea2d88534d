"""The multi-seam carve loop — static shapes, dynamic logical width.

XLA traces everything once: the whole N-seam carve is ONE jitted program.
Buffers keep the original width W0; a scalar `width` tracks the logical width
and columns >= width form a "dead region" that is (a) edge-filled in the luma
plane so window clamping matches the reference's border behavior
(`src/render.c:122-132`), and (b) masked to +inf in the energy so the DP never
enters it.  This replaces the reference's realloc-per-seam carver state with a
fixed layout of static shapes.

Each seam's DP runs as the GPU kernel or as XLA's scan, as
`dct_carver_tpu.platform` decides; every other stage is XLA.

Seam bookkeeping matches liblqr's visibility maps (`src/render.c:204-240`):
`vmap[y, x_original] = k` if the pixel was removed by the k-th seam, else 0.

Energy recomputation between seams supports two modes with identical results
(asserted in tests):
  * full  — recompute the whole map every seam (simple; the semantics anchor);
  * strip — recompute only a static-width strip around the removed seam; a
    pixel's energy can only change if its (2r×2r) window overlaps a changed
    column, and seam columns drift <= 1/row (delta_x=1), so a half-width of
    2r ( + 1 slack) columns around the seam covers every affected window.
    This is the moral equivalent of liblqr's incremental energy update.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import platform
from .dct import dct_energy_map, energy_from_bands
from .dp import check_tie, cumulative_energy, backtrack, mask_energy, remove_seam


def _bands_energy(bands, n: int, edges, textures, energy_fn):
    """One dispatch point for window energies: the builtin DCT chains or a
    pluggable EnergyFunction (ops/energy_fn.py — the lqr_carver_set_energy_
    function analog).  Both the full-image path and the strip updates funnel
    through here, so strip == full stays bitwise for every energy."""
    if energy_fn is not None:
        return energy_fn.bands_fn(bands)
    return energy_from_bands(bands, n, edges, textures)

__all__ = ["CarveState", "carve_n_seams", "make_state", "reconstruct_removed", "reconstruct_enlarged"]


class CarveState(NamedTuple):
    luma: jax.Array     # (H, W0) float — current image, dead region edge-filled
    origcol: jax.Array  # (H, W0) int32 — original column of each current pixel
    vmap: jax.Array     # (H, W0) int32 — visibility map in ORIGINAL coordinates
    width: jax.Array    # () int32 — logical width
    energy: jax.Array   # (H, W0) float32 — current energy (dead region garbage)


def make_state(luma: jax.Array) -> CarveState:
    H, W = luma.shape
    return CarveState(
        luma=luma,
        origcol=jnp.broadcast_to(jnp.arange(W, dtype=jnp.int32), (H, W)),
        vmap=jnp.zeros((H, W), jnp.int32),
        width=jnp.asarray(W, jnp.int32),
        energy=jnp.zeros((H, W), jnp.float32),
    )


def _edge_fill(luma: jax.Array, width: jax.Array) -> jax.Array:
    """Replicate column width-1 into the dead region (border clamp semantics)."""
    H, W = luma.shape
    edge = jnp.take_along_axis(luma, jnp.broadcast_to(width - 1, (H, 1)), axis=1)
    col = jnp.arange(W)[None, :]
    return jnp.where(col < width, luma, edge)


def _strip_bounds(seam: jax.Array, blocksize: int, W: int, delta_x: int = 1):
    """Static-width strip around a removed seam covering all affected windows.

    After removing column s_i in row i, a pixel (i, j) (new indexing) has a
    changed window iff some row r within the window's vertical extent has
    |j - s_r| <= r_blk (+1 for the index shift).  |s_r - s_i| <=
    delta_x * blocksize/2 within the extent, so half-width =
    blocksize/2 * (1 + delta_x) + 1 suffices (= blocksize + 1 at delta_x=1).
    """
    half = (blocksize // 2) * (1 + delta_x) + 1
    strip_w = 2 * half + 2  # a little slack; static
    start = jnp.clip(seam - half, 0, max(W - strip_w, 0))
    return start, strip_w


STRIP_ROW_BLOCK = 8  # default rows per block-aligned strip (static)


def strip_row_block(H: int, blocksize: int, delta_x: int = 1,
                    W: int | None = None) -> int:
    """Rows per block-shared strip window.  A taller block means fewer
    slab gathers and strip writes per seam, at the cost of a wider shared
    window (the seam drifts <= delta_x cols/row, so the window widens by
    delta_x*(R-1)).  Picks the largest candidate R that divides H while the
    tap window stays within 128 columns and the strip fits the image width.
    Seams do not depend on R.  The candidates and the 128-column bound are
    inherited values, not yet tuned for the H100."""
    for R in (120, 112, 104, 96, 88, 80, 72, 64, 56, 48, 40, 32, 24, 16, 8):
        if (H % R == 0
                and _strip_block_dims(blocksize, delta_x, R)[1] <= 128
                and (W is None or min_strip_width(blocksize, delta_x, R) <= W)):
            return R
    return STRIP_ROW_BLOCK


def min_strip_width(blocksize: int, delta_x: int = 1,
                    R: int = STRIP_ROW_BLOCK) -> int:
    """Smallest image width on which the block-aligned strip update fits."""
    swb, _ = _strip_block_dims(blocksize, delta_x, R)
    return swb + max(blocksize, 1)


def _recompute_strip(state: CarveState, seam: jax.Array, blocksize: int,
                     edges, textures, delta_x: int = 1,
                     energy_fn=None) -> jax.Array:
    """Compacted energy with only the seam strip recomputed — block-aligned.

    The old energy is compacted with the same select-shift as the image.  The
    seam drifts <= 1 column/row, so within an R-row block all per-row strips
    fit in one shared window widened by R-1 columns; the luma slab for a block
    is then ONE contiguous 2-D `dynamic_slice` instead of a per-row general
    gather, and the block strip goes back with one `dynamic_update_slice`.
    Recomputed columns go through the SAME `energy_from_bands` core as the
    full path, so every written value is bitwise equal to a full recompute;
    writing the wider block strip is therefore harmless (it overwrites
    correct values with identical ones).

    Border clamping (src/render.c:146-151): edge-mode padding of the slab
    source replicates the clamp; the dead region is edge-filled, so the right
    padding reads the logical-edge value like the full path.
    """
    H, W = state.luma.shape
    n = blocksize
    r = n // 2
    R = strip_row_block(H, n, delta_x, W)
    E_shift = remove_seam(state.energy, seam)
    start, strip_w = _strip_bounds(seam, n, W, delta_x)

    nb = -(-H // R)
    pad_h = nb * R - H
    swb, _ = _strip_block_dims(n, delta_x, R)  # block strip width (static)
    gwb = swb + n - 1              # + window taps
    # padded luma: rows r-1 top / r+pad_h bottom, cols r-1 left / r right —
    # edge replication == the full path's index clamping
    lp = jnp.pad(state.luma, ((r - 1, r + pad_h), (r - 1, r)), mode="edge")

    start_p = jnp.pad(start, (0, pad_h), mode="edge").reshape(nb, R)
    bs = jnp.clip(jnp.min(start_p, axis=1), 0, max(W - swb, 0))  # (nb,)

    # one contiguous (R+n-1, gwb) slab per block; padded-coord col start == bs
    slabs = jax.vmap(
        lambda k, b: jax.lax.dynamic_slice(lp, (k, b), (R + n - 1, gwb))
    )(jnp.arange(nb, dtype=jnp.int32) * R, bs)
    # per-output-row vertical bands via static row windows: (nb, R, n, gwb)
    bands = jnp.stack([slabs[:, rr : rr + n, :] for rr in range(R)], axis=1)
    strip_E = _bands_energy(
        bands.reshape(nb * R, n, gwb), n, edges, textures, energy_fn
    ).astype(jnp.float32).reshape(nb, R, swb)

    # write each block strip back at its block start (full-slice scatter)
    E_blocks = jnp.pad(E_shift, ((0, pad_h), (0, 0))).reshape(nb, R, W)
    out = jax.vmap(
        lambda e, s, b: jax.lax.dynamic_update_slice(e, s, (0, b))
    )(E_blocks, strip_E, bs)
    return out.reshape(nb * R, W)[:H]


def _strip_block_dims(blocksize: int, delta_x: int = 1,
                      R: int = STRIP_ROW_BLOCK):
    """(swb, gwb): static widths of the block-shared strip and its tap window."""
    half = (blocksize // 2) * (1 + delta_x) + 1
    strip_w = 2 * half + 2
    swb = strip_w + delta_x * (R - 1)
    return swb, swb + blocksize - 1


def find_seam(E: jax.Array, width: jax.Array, delta_x: int = 1,
              rigidity: float = 0.0, tie: str = "leftmost",
              interpret: bool = False) -> jax.Array:
    """Seam of the masked energy: the GPU DP kernel where
    `platform.seam_dp_kernel` picks it, else XLA's forward and backtrack
    scans.  Both give bitwise the same seam.  Its device ops carry the
    name scope "seam_dp" in profiler traces."""
    with jax.named_scope("seam_dp"):
        if platform.seam_dp_kernel(E.shape[1], delta_x, rigidity, interpret):
            from ..pallas import seam_dp

            return seam_dp.find_seam(E, width, tie=tie, interpret=interpret)
        M = cumulative_energy(mask_energy(E, width), delta_x, rigidity)
        return backtrack(M, delta_x, rigidity, tie)


def _one_seam(state: CarveState, k: jax.Array, blocksize: int, edges, textures,
              strip_update: bool, delta_x: int = 1, rigidity: float = 0.0,
              energy_fn=None, tie: str = "leftmost",
              interpret: bool = False) -> CarveState:
    W = state.luma.shape[1]
    seam = find_seam(state.energy, state.width, delta_x, rigidity, tie,
                     interpret)

    # record k-th seam at original coordinates (src/render.c:204-240
    # semantics).  One-hot select instead of gather + scatter: the
    # row-indexed scatter lowers to a general scatter, the two masked passes
    # to plain fused loops; values are identical because vmap is indexed by
    # original coordinate, so exactly one column per row equals `orig`.
    col = jnp.arange(W, dtype=jnp.int32)[None, :]
    hit = col == seam[:, None]
    orig = jnp.sum(jnp.where(hit, state.origcol, 0), axis=1)
    vmap = jnp.where(col == orig[:, None], k, state.vmap)

    new_width = state.width - 1
    luma = _edge_fill(remove_seam(state.luma, seam), new_width)
    origcol = remove_seam(state.origcol, seam)

    n_eff = energy_fn.n if energy_fn is not None else blocksize
    if strip_update:
        mid = state._replace(luma=luma, width=new_width)
        energy = _recompute_strip(mid, seam, n_eff, edges, textures,
                                  delta_x, energy_fn)
    else:
        energy = full_energy_map(luma, blocksize, edges, textures,
                                 energy_fn=energy_fn)

    return CarveState(luma, origcol, vmap, new_width, energy)


def full_energy_map(luma: jax.Array, blocksize: int, edges, textures,
                    center: str = "carve", energy_fn=None) -> jax.Array:
    """Full-image energy, f32.  With a pluggable `energy_fn`
    (ops/energy_fn.py) the function's own vectorized path runs instead of
    the DCT chains."""
    if energy_fn is not None:
        return energy_fn.energy_map(luma, center).astype(jnp.float32)
    return dct_energy_map(luma, blocksize, edges, textures,
                          center=center).astype(jnp.float32)


@functools.partial(
    jax.jit,
    static_argnames=("n_seams", "blocksize", "strip_update", "delta_x",
                     "rigidity", "energy_fn", "tie", "interpret"),
)
def carve_n_seams(
    luma: jax.Array,
    n_seams: int,
    blocksize: int,
    edges,
    textures,
    strip_update: bool = True,
    delta_x: int = 1,
    rigidity: float = 0.0,
    energy_fn=None,
    tie: str = "leftmost",
    interpret: bool = False,
) -> CarveState:
    """Remove `n_seams` vertical seams from a (H, W) luma plane.

    Returns the final CarveState; the caller reconstructs outputs from `vmap`
    (see `reconstruct_removed` / `reconstruct_enlarged`).  The first energy
    map is computed in full; subsequent seams use strip updates when enabled.
    `delta_x`/`rigidity` generalize liblqr's `lqr_carver_init` parameters
    (see ops.dp._rigidity_penalties).  `energy_fn`: a pluggable
    ops.energy_fn.EnergyFunction replacing the DCT energy (the
    lqr_carver_set_energy_function analog); `blocksize`/`edges`/`textures`
    are ignored when it is set.  `tie`: "leftmost"/"rightmost" DP tie rule
    (the S1/S2 spec knob of docs/PARITY.md, applied in the end-column argmin
    and every backtrack step).  `interpret=True` runs the GPU kernels
    through the Pallas interpreter (tests on hosts without a GPU).
    """
    check_tie(tie)
    H, W = luma.shape
    if delta_x < 1:
        raise ValueError(f"delta_x must be >= 1, got {delta_x}")
    state = make_state(luma)
    # energy is stored as f32 — liblqr's gfloat (src/dct.c:96) — no matter
    # the compute dtype; the DP then matches the oracle's f32 arithmetic
    E0 = full_energy_map(luma, blocksize, edges, textures, energy_fn=energy_fn)
    state = state._replace(energy=E0)

    # strips wider than the buffer would scatter out of bounds: fall back to
    # full recompute for tiny images (static decision; W is a trace constant)
    n_eff = energy_fn.n if energy_fn is not None else blocksize
    if W < min_strip_width(n_eff, delta_x,
                           strip_row_block(H, n_eff, delta_x, W)):
        strip_update = False

    def body(i, s):
        return _one_seam(s, (i + 1).astype(jnp.int32), blocksize, edges,
                         textures, strip_update, delta_x, rigidity,
                         energy_fn, tie, interpret)

    return jax.lax.fori_loop(0, n_seams, body, state)


@functools.partial(jax.jit, static_argnames=("n_seams",))
def reconstruct_removed(image: jax.Array, vmap: jax.Array, n_seams: int) -> jax.Array:
    """Apply all removal seams in `vmap` to the full-channel image.

    image: (H, W[, C]); returns (H, W-n_seams[, C]).  Stable argsort keeps
    surviving columns in order (one gather; runs once per carve, not per seam).
    """
    H, W = image.shape[:2]
    removed = vmap > 0
    order = jnp.argsort(removed, axis=1, stable=True)[:, : W - n_seams]
    idx = order[..., None] if image.ndim == 3 else order
    return jnp.take_along_axis(image, idx, axis=1)


@functools.partial(jax.jit, static_argnames=("n_seams",))
def reconstruct_enlarged(image: jax.Array, vmap: jax.Array, n_seams: int) -> jax.Array:
    """Insert a duplicate after every seam pixel (liblqr enlargement semantics).

    Inserted value = mean of the seam pixel and its right neighbor
    (border-clamped); round-half-up for integer dtypes.
    """
    H, W = image.shape[:2]
    out_w = W + n_seams
    s = (vmap > 0).astype(jnp.int32)
    offs = jnp.cumsum(s, axis=1) - s                      # exclusive cumsum
    pos = jnp.arange(W)[None, :] + offs                   # out position of originals
    rows = jnp.broadcast_to(jnp.arange(H)[:, None], (H, W))

    nbr = jnp.concatenate([image[:, 1:], image[:, -1:]], axis=1)
    if jnp.issubdtype(image.dtype, jnp.integer):
        avg = (
            (image.astype(jnp.int32) + nbr.astype(jnp.int32) + 1) // 2
        ).astype(image.dtype)
    else:
        avg = (image + nbr) / 2

    if image.ndim == 3:
        out = jnp.zeros((H, out_w, image.shape[2]), image.dtype)
        out = out.at[rows, pos].set(image)
        dup_pos = jnp.where(s == 1, pos + 1, pos)
        dup_val = jnp.where((s == 1)[..., None], avg, image)
        out = out.at[rows, dup_pos].set(dup_val)
    else:
        out = jnp.zeros((H, out_w), image.dtype)
        out = out.at[rows, pos].set(image)
        dup_pos = jnp.where(s == 1, pos + 1, pos)
        dup_val = jnp.where(s == 1, avg, image)
        out = out.at[rows, dup_pos].set(dup_val)
    return out
