"""Spatially-sharded single-image carving — one huge image over a device mesh.

Config 5 of BASELINE.md: an 8K panorama column-sharded over N devices/hosts.
The reference has no analog (SURVEY §2 parallelism table); the constraints it
fixes are (a) the energy's sliding window needs a blocksize-wide column halo
(`src/render.c:146-151` geometry), and (b) liblqr's column-DP recurrence
(delta_x=1) must cross tile boundaries so seams stay globally optimal.

Design (`shard_map` over a 1-D mesh axis "x", columns sharded),
with collectives BLOCKED over K rows so their count is O(H/K) per seam
instead of O(H) (the r2 per-row frontier exchange):

* energy   — halo exchange (r-1 left / r right cols), then the SAME
             `energy_from_bands` core as single-device → the sharded energy
             is bitwise equal to the unsharded one.  Computed in full once;
             per-seam updates recompute only the seam strip (below).
* DP       — K-row trapezoid blocks: ONE ppermute pair per K rows exchanges
             a 2K-column halo of the frontier row + the K-row energy block;
             the min-plus recurrence then runs K rows locally on the
             halo-extended width.  With delta_x=1 a value |dc| columns from
             exact data is correct for |dc| rows, so the owned columns stay
             EXACTLY the global recurrence (trapezoid argument, see
             `_sharded_dp`).
* backtrack— the seam drifts <= 1 col/row, so a K-row segment stays within
             +-K columns of its entry point: the shard owning the entry
             column walks the whole segment locally on its halo-extended M
             and ONE psum per K rows broadcasts it (plus one pmin pair for
             the global leftmost argmin of the last row).
* strip    — per-seam energy update recomputes only the static-width strip
             around the removed seam (bitwise equal to a full recompute,
             like ops/carve.py): one luma halo exchange per seam, then the
             same block-aligned slab/energy/scatter locally per shard.
* removal  — per-shard select-shift compaction; the boundary pixel flows in
             from the right neighbor via `ppermute`.

The result is seam-for-seam identical to `ops.carve.carve_n_seams`
(asserted in tests/test_spatial.py).  Every per-shard stage is plain XLA;
the collectives are lowered by XLA (NCCL on GPUs).
`collectives_per_seam` gives the per-seam collective budget: ~3*ceil(H/K)+9
vs ~3*H for the per-row design (>30x fewer at 8K with K=32).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.dp import _argmin_tie, _rigidity_penalties, _shift_row
from ..ops.energy_fn import resolve_energy
from ..ops.carve import (_bands_energy, _strip_bounds, _strip_block_dims,
                         min_strip_width, strip_row_block)
from .mesh import make_mesh

__all__ = ["spatial_carve_n_seams", "spatial_enlarge_n_seams",
           "spatial_make_state",
           "SpatialCarveResult", "SpatialCarveState",
           "collectives_per_seam"]

# Rows per DP/backtrack collective exchange (K).  Fewer, taller blocks mean
# fewer collectives per seam (`collectives_per_seam`) and a wider frontier
# halo.  The value is inherited, not yet tuned for the H100.  Seams are
# identical for any K (trapezoid exactness).
FRONTIER_BLOCK = 96


def collectives_per_seam(H: int, K: int = FRONTIER_BLOCK,
                         blocked: bool = True) -> int:
    """Collective-op count per carved seam (single-hop halo regime).

    Blocked design: 2 ppermutes per K-row DP block, 1 psum per K-row
    backtrack segment + 2 pmin (global argmin), 2 ppermutes (strip halo),
    compaction + edge fill (3 ppermutes + 1 psum), 1 psum (vmap
    bookkeeping).  Per-row design (for comparison): 2 ppermutes per DP row
    + 1 psum per backtrack row."""
    nb = -(-H // K)
    if blocked:
        return 2 * nb + (nb + 2) + 2 + 4 + 1
    return 3 * H


def _axis_index(axis):
    return jax.lax.axis_index(axis)


def _pvary(x, axis):
    """Mark a replicated value as varying over `axis` (shard_map scan carries
    must have consistent varying-axis types)."""
    if hasattr(jax.lax, "pcast"):
        return jax.lax.pcast(x, (axis,), to="varying")
    return jax.lax.pvary(x, (axis,))


def _from_left(x, axis):
    """Each shard receives x from its LEFT neighbor (shard 0 receives zeros)."""
    n = jax.lax.axis_size(axis)
    perm = [(i, i + 1) for i in range(n - 1)]
    return jax.lax.ppermute(x, axis, perm)


def _from_right(x, axis):
    """Each shard receives x from its RIGHT neighbor (last shard gets zeros)."""
    n = jax.lax.axis_size(axis)
    perm = [(i + 1, i) for i in range(n - 1)]
    return jax.lax.ppermute(x, axis, perm)


def _halo_gather(x, n_left: int, n_right: int, axis):
    """(H', Wl) -> (H', n_left + Wl + n_right): append neighbor column halos.

    Single-hop halos ship ONLY the edge columns (slicing commutes with
    ppermute, so values are identical to permuting the full block — but the
    message is n_halo/Wl of the size: bytes exchanged per seam go from
    O(H*Wl) to O(H*halo)).  Multi-hop
    (halo wider than one shard — tiny test shards) keeps the full-width
    relay.  Positions beyond the mesh ends arrive as ZEROS — callers mask
    or clamp them by global column index."""
    Wl = x.shape[1]
    parts = []
    if n_left:
        if n_left <= Wl:
            parts.append(_from_left(x[:, Wl - n_left:], axis))
        else:
            hops, blocks, cur = -(-n_left // Wl), [], x
            for _ in range(hops):
                cur = _from_left(cur, axis)
                blocks.append(cur)
            parts.append(jnp.concatenate(blocks[::-1], axis=1)[:, -n_left:])
    parts.append(x)
    if n_right:
        if n_right <= Wl:
            parts.append(_from_right(x[:, :n_right], axis))
        else:
            hops, blocks, cur = -(-n_right // Wl), [], x
            for _ in range(hops):
                cur = _from_right(cur, axis)
                blocks.append(cur)
            parts.append(jnp.concatenate(blocks, axis=1)[:, :n_right])
    return jnp.concatenate(parts, axis=1)


def _edge_clamped_halo(local, n_left: int, n_right: int, W: int, axis):
    """Halo gather with GLOBAL edge-clamp semantics (src/render.c:122-132):
    columns beyond [0, W) replicate global column 0 / W-1.

    The clamps are applied to the HALO SLICES before the concat (identical
    values — the affected slots are exactly the same): clamping the full
    extended buffer instead costs two full-width select passes for a
    handful of edge columns (~0.7 ms/seam at 8K)."""
    idx = _axis_index(axis)
    nsh = jax.lax.axis_size(axis)
    H, Wl = local.shape
    lo = idx * Wl
    parts = []
    if n_left:
        lh = _halo_gather(local, n_left, 0, axis)[:, :n_left]
        col_g = lo - n_left + jnp.arange(n_left)[None, :]
        if n_left <= Wl:
            left_fill = local[:, :1]  # only shard 0 has col_g < 0; owns col 0
        else:
            own0 = jnp.where(idx == 0, local[:, 0], 0.0)
            left_fill = jax.lax.psum(own0, axis)[:, None]
        parts.append(jnp.where(col_g < 0, left_fill, lh))
    parts.append(local)
    if n_right:
        rh = _halo_gather(local, 0, n_right, axis)[:, Wl:]
        col_g = lo + Wl + jnp.arange(n_right)[None, :]
        if n_right <= Wl:
            right_fill = local[:, -1:]
        else:
            ownl = jnp.where(idx == nsh - 1, local[:, -1], 0.0)
            right_fill = jax.lax.psum(ownl, axis)[:, None]
        parts.append(jnp.where(col_g > W - 1, right_fill, rh))
    return jnp.concatenate(parts, axis=1)


def _sharded_energy(local_luma, blocksize, edges, textures, W, axis,
                    energy_fn=None):
    """(H, Wl) local luma -> (H, Wl) energy, bitwise equal to unsharded.
    `energy_fn`: a pluggable ops.energy_fn.EnergyFunction replacing the DCT
    energy (the lqr_carver_set_energy_function analog threaded through the
    sharded path — same bands interface as the single-device one)."""
    n = energy_fn.n if energy_fn is not None else blocksize
    r = n // 2
    H, Wl = local_luma.shape
    ext = _edge_clamped_halo(local_luma, r - 1, r, W, axis)  # (H, Wl + n - 1)
    row_idx = jnp.clip(
        jnp.arange(H)[:, None] + jnp.arange(-r + 1, r + 1)[None, :], 0, H - 1
    )
    bands = ext[row_idx]  # (H, n, Wl + n - 1)
    return _bands_energy(bands, n, edges, textures,
                         energy_fn).astype(jnp.float32)


# -------------------------------------------------------------------- DP ----

def _sharded_dp(E_local, width, K: int, axis, unroll: bool = False,
                delta_x: int = 1, rigidity: float = 0.0):
    """Blocked sharded cumulative energy.  E_local (H, Wl) f32 (unmasked);
    returns ext_M (H, We) with We = Wl + 4·K·delta_x (halo Hh = 2·K·delta_x
    columns per side; ext column e holds global column lo - Hh + e).

    Trapezoid exactness: the frontier/energy halos are exchanged EXACTLY
    once per K-row block and the seam recurrence moves <= delta_x
    columns/row, so after t local scan steps ext positions
    [t·delta_x + 1, We - 2 - t·delta_x] hold the true global M.  The owned
    slice [Hh, Hh + Wl) is always exact; the extra halo width (2·K·delta_x
    instead of K·delta_x + 1) is what the blocked backtrack needs (see
    `_sharded_backtrack`).  The recurrence mirrors ops.dp.cumulative_energy
    (same candidate fold order and rigidity penalties, so seams stay
    bitwise-identical to the single-device path)."""
    idx = _axis_index(axis)
    H, Wl = E_local.shape
    d = delta_x
    Hh = 2 * K * d
    We = Wl + 2 * Hh
    lo = idx * Wl
    inf = jnp.float32(jnp.inf)
    col_g = lo - Hh + jnp.arange(We)
    valid = (col_g >= 0) & (col_g < width)
    pen = _rigidity_penalties(d, rigidity, jnp.float32)

    def block(prev, E_blk):
        # one ppermute pair ships the frontier row + the K-row energy block
        msg = jnp.concatenate([prev[None, :], E_blk], axis=0)
        ext = _halo_gather(msg, Hh, Hh, axis)          # (Kb + 1, We)

        ext_prev = jnp.where(valid, ext[0], inf)
        ext_E = jnp.where(valid[None, :], ext[1:], inf)

        def row(prev_e, e_row):
            # same candidate order + op fold as ops/dp.py cumulative_energy
            best = None
            for k2, dx in enumerate(range(-d, d + 1)):
                cand = _shift_row(prev_e, dx, inf)
                if pen[k2] != 0.0:
                    cand = cand + jnp.float32(pen[k2])
                best = cand if best is None else jnp.minimum(best, cand)
            m = e_row + best
            return m, m

        _, Ms = jax.lax.scan(row, ext_prev, ext_E)     # (Kb, We)
        return Ms[-1, Hh:Hh + Wl], Ms

    nfull, rem = H // K, H % K
    # m0 = e0 + 0.0 (== e0 in every comparison); pvary for scan-carry typing
    prev = _pvary(jnp.zeros((Wl,), jnp.float32), axis)
    chunks = []
    if nfull:
        prev, Ms = jax.lax.scan(block, prev, E_local[:nfull * K]
                                .reshape(nfull, K, Wl), unroll=unroll)
        chunks.append(Ms.reshape(nfull * K, We))
    if rem:
        _, Ms_r = block(prev, E_local[nfull * K:])
        chunks.append(Ms_r)
    return jnp.concatenate(chunks, axis=0) if len(chunks) > 1 else chunks[0]


# -------------------------------------------------------------- backtrack ---

def _seg_walk(ext_M_rows, j_bottom, Wl: int, K: int, axis,
              delta_x: int = 1, rigidity: float = 0.0,
              tie: str = "leftmost"):
    """Walk one backtrack segment locally on the owner shard of `j_bottom`,
    then broadcast it.  ext_M_rows: (Kb, We) rows [s-1, e-1) of ext_M;
    j_bottom: () i32 global seam column at row e-1 (replicated).  Returns
    (Kb,) global seam columns for rows [s-1, e-1), replicated.

    The seam drifts <= delta_x col/row, so the whole segment lies in the
    ±K·delta_x-column window around j_bottom, which the owner's 2·K·delta_x
    halo covers exactly (the needed cells sit inside the trapezoid-exact
    region — see _sharded_dp).  Step rule mirrors ops.dp.backtrack
    (penalized window, leftmost argmin)."""
    Kb = ext_M_rows.shape[0]
    d = delta_x
    idx = _axis_index(axis)
    lo = idx * Wl
    We = ext_M_rows.shape[1]
    Hh = (We - Wl) // 2
    owned = (j_bottom >= lo) & (j_bottom < lo + Wl)
    wstart = jnp.clip(j_bottom - lo + Hh - K * d, 0, We - (2 * K * d + 1))
    win = jax.lax.dynamic_slice(ext_M_rows, (0, wstart), (Kb, 2 * K * d + 1))
    winp = jnp.pad(win, ((0, 0), (d, d)), constant_values=jnp.inf)
    pen = jnp.asarray(_rigidity_penalties(d, rigidity, jnp.float32),
                      jnp.float32)

    def step(jl, row_p):
        # padded (2d+1)-window [jl-d .. jl+d]; tie-most-min rule
        wd = jax.lax.dynamic_slice(row_p, (jl,), (2 * d + 1,))
        if rigidity != 0.0:
            wd = wd + pen
        jn = jl - d + _argmin_tie(wd, tie)
        return jn, jn

    _, seg_rev = jax.lax.scan(step, _pvary(jnp.int32(K * d), axis),
                              winp[::-1])
    seg = seg_rev[::-1]
    seg_g = seg + (j_bottom - K * d)                   # rows [s-1, e-1)
    seg_g = jnp.where(owned, seg_g, 0)
    return jax.lax.psum(seg_g, axis)


def _sharded_backtrack(ext_M, width, K: int, axis, Wl: int,
                       unroll: bool = False,
                       delta_x: int = 1, rigidity: float = 0.0,
                       tie: str = "leftmost"):
    """Global tie-most-min backtrack over the blocked sharded M.
    Returns (H,) global seam columns, replicated on every shard; `Wl` is
    the owned width."""
    H, We = ext_M.shape
    Hh = (We - Wl) // 2
    idx = _axis_index(axis)
    lo = idx * Wl
    inf = jnp.float32(jnp.inf)

    # tie-most global argmin of the masked last row: local tie-most argmin
    # per shard, then min/max over the shards holding the global minimum
    col_g = lo + jnp.arange(Wl)
    last = jnp.where(col_g < width, ext_M[-1, Hh:Hh + Wl], inf)
    lmin = jnp.min(last)
    gmin = jax.lax.pmin(lmin, axis)
    if tie == "leftmost":
        larg = (lo + jnp.argmin(last)).astype(jnp.int32)
        cand = jnp.where(lmin == gmin, larg, jnp.iinfo(jnp.int32).max)
        j = jax.lax.pmin(cand, axis).astype(jnp.int32)
    else:
        larg = (lo + Wl - 1 - jnp.argmin(last[::-1])).astype(jnp.int32)
        cand = jnp.where(lmin == gmin, larg, jnp.int32(-1))
        j = jax.lax.pmax(cand, axis).astype(jnp.int32)
    j_last = j

    nfull, rem = H // K, H % K
    segs = []  # collected bottom-up; each (len,) for rows [start, start+len)

    if nfull == 0:
        seg = _seg_walk(ext_M[: H - 1], j, Wl, K, axis, delta_x,
                        rigidity, tie)  # rows [0, H-1)
        segs.append(seg)
    else:
        if rem:
            # remainder chunk: rows [nfull*K - 1, H - 1)
            seg = _seg_walk(ext_M[nfull * K - 1: H - 1], j, Wl, K, axis,
                            delta_x, rigidity, tie)
            segs.append(seg)
            j = seg[0]
        if nfull > 1:
            def chunk(jc, b):
                rows = jax.lax.dynamic_slice(
                    ext_M, (b * K - 1, 0), (K, We))    # rows [bK-1, bK+K-1)
                seg = _seg_walk(rows, jc, Wl, K, axis, delta_x, rigidity,
                                tie)
                return seg[0], seg

            bs = jnp.arange(nfull - 1, 0, -1)
            j, seg_stack = jax.lax.scan(chunk, j, bs,
                                        unroll=unroll)  # (nfull-1, K)
            segs.append(seg_stack[::-1].reshape((nfull - 1) * K))
        # block-0 chunk: rows [0, K-1)
        seg0 = _seg_walk(ext_M[: K - 1], j, Wl, K, axis, delta_x, rigidity,
                         tie)
        segs.append(seg0)

    return jnp.concatenate(segs[::-1] + [j_last[None]])


# ------------------------------------------------------------ strip update --

def _sharded_strip_update(luma_l, E_shift, seam, blocksize: int, edges,
                          textures, W: int, axis, delta_x: int = 1,
                          energy_fn=None):
    """Per-seam sharded energy update: recompute only the strip around the
    removed seam.  Bitwise equal at every owned live column to the
    single-device `_recompute_strip` (same slab values -> same
    `energy_from_bands` chains -> same written columns).  With `energy_fn`,
    `blocksize` must be the function's window size (energy_fn.n)."""
    H, Wl = luma_l.shape
    n = blocksize
    R = strip_row_block(H, n, delta_x, W)  # same blocks as single-device
    r = n // 2
    idx = _axis_index(axis)
    lo = idx * Wl

    start, _ = _strip_bounds(seam, n, W, delta_x)      # (H,) global
    nb = -(-H // R)
    pad_h = nb * R - H
    swb, gwb = _strip_block_dims(n, delta_x, R)
    start_p = jnp.pad(start, (0, pad_h), mode="edge").reshape(nb, R)
    bs = jnp.clip(jnp.min(start_p, axis=1), 0, max(W - swb, 0))  # (nb,) global

    # halo-extended luma covering every slab that can overlap this shard
    HL, HR = swb + r - 1, swb + r
    ext = _edge_clamped_halo(luma_l, HL, HR, W, axis)  # (H, HL + Wl + HR)
    extp = jnp.pad(ext, ((r - 1, r + pad_h), (0, 0)), mode="edge")

    # slab for block k starts at ext col bs + swb - lo (clip only moves
    # blocks with NO overlap with this shard; their values are discarded)
    ext_w = ext.shape[1]
    es = jnp.clip(bs + swb - lo, 0, ext_w - gwb)
    slabs = jax.vmap(
        lambda k, b: jax.lax.dynamic_slice(extp, (k, b), (R + n - 1, gwb))
    )(jnp.arange(nb, dtype=jnp.int32) * R, es)
    bands = jnp.stack([slabs[:, rr: rr + n, :] for rr in range(R)], axis=1)
    strip_E = _bands_energy(
        bands.reshape(nb * R, n, gwb), n, edges, textures, energy_fn
    ).astype(jnp.float32).reshape(nb, R, swb)

    # scatter into a swb-per-side halo frame; halo writes are discarded
    Eb = jnp.pad(E_shift, ((0, pad_h), (swb, swb))).reshape(nb, R, Wl + 2 * swb)
    ts = jnp.clip(bs - lo + swb, 0, Wl + swb)
    out = jax.vmap(
        lambda e, s, b: jax.lax.dynamic_update_slice(e, s, (0, b))
    )(Eb, strip_E, ts)
    return out.reshape(nb * R, Wl + 2 * swb)[:H, swb:swb + Wl]


# ------------------------------------------------------------- removal ------

def _sharded_remove(local, seam, axis):
    """Compaction with cross-boundary pixel flow.  local: (H, Wl[, C])."""
    H, Wl = local.shape[:2]
    idx = _axis_index(axis)
    lo = idx * Wl
    incoming = _from_right(local[:, :1], axis)  # right neighbor's first col
    shifted = jnp.concatenate([local[:, 1:], incoming], axis=1)
    keep = (lo + jnp.arange(Wl))[None, :] < seam[:, None]
    if local.ndim == 3:
        keep = keep[..., None]
    return jnp.where(keep, local, shifted)


def _sharded_edge_fill(local_luma, width, axis):
    """Replicate the logical edge column (global width-1) into the dead region."""
    H, Wl = local_luma.shape
    idx = _axis_index(axis)
    lo = idx * Wl
    li = width - 1 - lo
    owned = (li >= 0) & (li < Wl)
    edge = jnp.where(owned, local_luma[:, jnp.clip(li, 0, Wl - 1)], 0.0)
    edge = jax.lax.psum(edge, axis)  # (H,) replicated
    col_g = (lo + jnp.arange(Wl))[None, :]
    return jnp.where(col_g < width, local_luma, edge[:, None])


# ------------------------------------------------------------- seam step ----

def _spatial_seam_step(st, label, blocksize: int, edges, textures, W: int,
                       Wl: int, K: int, strip_update: bool, with_image: bool,
                       axis, unroll: bool = False, delta_x: int = 1,
                       rigidity: float = 0.0, energy_fn=None,
                       tie: str = "leftmost", defer_record: bool = False):
    """One full sharded seam: DP -> backtrack -> vmap record -> compaction ->
    energy update.  `st` is the 6-tuple of per-shard state; `label` is the
    1-based seam number written into the visibility map.  `unroll=True`
    unrolls the collective-bearing block scans (used by
    `measure_collectives_per_seam` so static HLO op count == dynamic count;
    the per-row scans carry no collectives and stay rolled)."""
    luma_l, img_l, origcol_l, vmap_l, E_l, width = st
    H = luma_l.shape[0]
    idx = _axis_index(axis)
    lo = idx * Wl

    ext_M = _sharded_dp(E_l, width, K, axis, unroll=unroll,
                        delta_x=delta_x, rigidity=rigidity)
    seam = _sharded_backtrack(ext_M, width, K, axis, Wl, unroll=unroll,
                              delta_x=delta_x, rigidity=rigidity,
                              tie=tie)  # (H,)

    # removed pixel's ORIGINAL column — one-hot masked pass (the row-indexed
    # gather lowers to a general form; identical values, see ops/carve.py)
    col_l = jnp.arange(Wl, dtype=jnp.int32)[None, :]
    hit = col_l == (seam - lo)[:, None]  # matches only on owner shard
    orig = jax.lax.psum(
        jnp.sum(jnp.where(hit, origcol_l, 0), axis=1), axis
    )                                    # global original column (H,)

    width = width - 1
    luma_l = _sharded_edge_fill(_sharded_remove(luma_l, seam, axis), width,
                                axis)
    origcol_l = _sharded_remove(origcol_l, seam, axis)
    if with_image:
        img_l = _sharded_remove(img_l, seam, axis)
    if strip_update:
        E_shift = _sharded_remove(E_l, seam, axis)
        n_eff = energy_fn.n if energy_fn is not None else blocksize
        E_l = _sharded_strip_update(
            luma_l, E_shift, seam, n_eff, edges, textures, W, axis,
            delta_x=delta_x, energy_fn=energy_fn,
        )
    else:
        E_l = _sharded_energy(luma_l, blocksize, edges, textures, W, axis,
                              energy_fn)
    if not defer_record:
        # write into the vmap shard that owns each original column
        vmap_l = jnp.where(col_l == (orig - lo)[:, None], label, vmap_l)
    return (luma_l, img_l, origcol_l, vmap_l, E_l, width), orig


def measure_collectives_per_seam(
    H: int,
    W: int,
    mesh: Mesh | None = None,
    axis: str = "x",
    *,
    blocksize: int = 8,
    edges: float = 0.0,
    textures: float = 1.0,
    frontier_block: int = FRONTIER_BLOCK,
    strip_update: bool = True,
    delta_x: int = 1,
    rigidity: float = 0.0,
):
    """MEASURED collective count per carved seam: compile one unrolled seam
    step through the real shard_map lowering and count the collective ops in
    the optimized HLO.  Unlike `collectives_per_seam` (arithmetic over the
    design), this catches any collectives the partitioner inserts or merges.
    Returns {"total": n, "by_op": {...}, "designed": collectives_per_seam}.
    """
    import re

    if mesh is None:
        mesh = make_mesh(axis_name=axis)
    nsh = mesh.shape[axis]
    if W % nsh:
        raise ValueError(f"width {W} not divisible by mesh size {nsh}")
    Wl = W // nsh
    K = max(1, min(frontier_block, H))
    spec = P(None, axis)

    def shard_fn(luma_l, origcol_l, vmap_l, E_l, width0):
        img_l = jnp.zeros((1, 1), jnp.float32)
        st = (luma_l, img_l, origcol_l, vmap_l, E_l, width0[0])
        out, _ = _spatial_seam_step(st, jnp.int32(1), blocksize, edges,
                                    textures, W, Wl, K, strip_update, False,
                                    axis, unroll=True, delta_x=delta_x,
                                    rigidity=rigidity)
        return out[0], out[2], out[3], out[4], out[5][None]

    f = jax.jit(shard_map(
        shard_fn, mesh=mesh,
        in_specs=(spec, spec, spec, spec, P(axis)),
        out_specs=(spec, spec, spec, spec, P(axis)),
    ))
    f32 = jax.ShapeDtypeStruct((H, W), jnp.float32)
    i32 = jax.ShapeDtypeStruct((H, W), jnp.int32)
    w0 = jax.ShapeDtypeStruct((nsh,), jnp.int32)
    txt = f.lower(f32, i32, i32, f32, w0).compile().as_text()

    ops = ("collective-permute", "all-reduce", "all-gather", "all-to-all",
           "reduce-scatter")
    by_op = {
        op: len(re.findall(rf"\b{op}(?:-start)?\(", txt)) for op in ops
    }
    return {
        "total": sum(by_op.values()),
        "by_op": {k: v for k, v in by_op.items() if v},
        "designed": collectives_per_seam(H, K),
    }



# ------------------------------------------------------------ enlargement ---

def _sharded_enlarge(img_l, vmap_l, n_seams: int, W: int, Wlo: int, axis):
    """Per-shard sharded enlargement reconstruction (liblqr positive-seam
    semantics, src/render.c:344-364): every seam pixel is followed by a
    duplicate equal to the rounded mean of itself and its right ORIGINAL
    neighbor (border-clamped) — identical values to
    `ops.carve.reconstruct_enlarged` (asserted in tests).

    img_l (H, Wl[, C]) ORIGINAL image columns, vmap_l (H, Wl) i32 visibility
    map in original coordinates, Wlo = output columns per shard.  Output
    positions are computed with a global per-row prefix sum of seam flags
    (one all_gather of per-shard row totals), and each shard gathers the
    halo of original columns its output range can draw from (src(p) is
    within n_seams columns of p)."""
    idx = _axis_index(axis)
    nsh = jax.lax.axis_size(axis)
    H, Wl = img_l.shape[:2]
    lo = idx * Wl
    lo_out = idx * Wlo
    col_g = lo + jnp.arange(Wl)[None, :]

    sflag = (vmap_l > 0).astype(jnp.int32)             # (H, Wl)
    local_cum = jnp.cumsum(sflag, axis=1)
    totals = local_cum[:, -1]                          # (H,)
    all_tot = jax.lax.all_gather(totals, axis)         # (nsh, H)
    shard_ids = jnp.arange(nsh)[:, None]
    left = jnp.sum(jnp.where(shard_ids < idx, all_tot, 0), axis=0)  # (H,)
    offs_excl = local_cum - sflag + left[:, None]
    pos = col_g + offs_excl                            # (H, Wl) out position

    # halo of original columns: src(p) in [p - n_seams, p]
    HN_l = n_seams
    HN_r = n_seams + nsh
    ext_pos = _halo_gather(pos, HN_l, HN_r, axis)
    ext_s = _halo_gather(sflag, HN_l, HN_r, axis)
    if img_l.ndim == 3:
        C = img_l.shape[2]
        ext_img = jnp.stack([
            _halo_gather(img_l[..., c], HN_l, HN_r, axis) for c in range(C)
        ], axis=-1)
    else:
        ext_img = _halo_gather(img_l, HN_l, HN_r, axis)
    We2 = Wl + HN_l + HN_r
    ecol_g = lo - HN_l + jnp.arange(We2)[None, :]      # original col per slot
    big = jnp.int32(1) << 30
    # invalid halo slots sort strictly below/above every real position
    ext_pos = jnp.where(ecol_g < 0, -big + jnp.arange(We2)[None, :], ext_pos)
    ext_pos = jnp.where(ecol_g > W - 1, big + jnp.arange(We2)[None, :],
                        ext_pos)

    # src slot for each of my output positions: rightmost slot with
    # pos <= p (positions are strictly increasing per row)
    p_out = lo_out + jnp.arange(Wlo)                    # (Wlo,) global
    srch = jax.vmap(lambda row: jnp.searchsorted(
        row, p_out, side="right").astype(jnp.int32) - 1)
    i_src = jnp.clip(srch(ext_pos), 0, We2 - 1)         # (H, Wlo)

    take = lambda a, i: jnp.take_along_axis(a, i, axis=1)
    src_pos = take(ext_pos, i_src)
    src_s = take(ext_s, i_src)
    src_c = take(jnp.broadcast_to(ecol_g, ext_pos.shape), i_src)
    is_dup = (p_out[None, :] == src_pos + 1) & (src_s == 1)

    i_nbr = jnp.clip(jnp.where(src_c >= W - 1, i_src, i_src + 1), 0, We2 - 1)
    if img_l.ndim == 3:
        g3 = lambda i: take(ext_img.reshape(H, We2 * C),
                            (i[..., None] * C
                             + jnp.arange(C)[None, None, :]).reshape(H, -1)
                            ).reshape(H, Wlo, C)
        a = g3(i_src)
        b = g3(i_nbr)
        dup = is_dup[..., None]
    else:
        a = take(ext_img, i_src)
        b = take(ext_img, i_nbr)
        dup = is_dup
    if jnp.issubdtype(img_l.dtype, jnp.integer):
        avg = ((a.astype(jnp.int32) + b.astype(jnp.int32) + 1) // 2
               ).astype(img_l.dtype)
    else:
        avg = (a + b) / 2
    return jnp.where(dup, avg, a)


def spatial_enlarge_n_seams(
    luma,
    n_seams: int,
    image,
    *,
    blocksize: int = 8,
    edges: float = 0.0,
    textures: float = 1.0,
    mesh: Mesh | None = None,
    axis: str = "x",
    frontier_block: int = FRONTIER_BLOCK,
    strip_update: bool = True,
    delta_x: int = 1,
    rigidity: float = 0.0,
    energy=None,
    progress=None,
    tie: str = "leftmost",
    chunk: int = 0,
    checkpoint_dir: str | None = None,
    resume_from: str | None = None,
) -> SpatialCarveResult:
    """ENLARGE a column-sharded image by `n_seams` (the positive-seams mode
    of the reference, src/render.c:344-364): find n removal seams on a copy,
    then insert a duplicate after every seam pixel (rounded-mean values,
    liblqr semantics).  The seam search runs the full sharded carve; the
    insertion is a sharded gather driven by a global per-row prefix sum of
    seam flags (one all_gather) — no host gather at any point.  Returns a
    SpatialCarveResult whose .image is (H, W + n_seams[, C]) and .vmap the
    seam map in original coordinates; identical output to
    `ops.carve.reconstruct_enlarged` on the single-device vmap."""
    if mesh is None:
        mesh = make_mesh(axis_name=axis)
    nsh = mesh.shape[axis]
    H, W = luma.shape[:2]
    res = spatial_carve_n_seams(
        luma, n_seams, blocksize=blocksize, edges=edges, textures=textures,
        mesh=mesh, axis=axis, frontier_block=frontier_block,
        strip_update=strip_update, delta_x=delta_x, rigidity=rigidity,
        energy=energy, progress=progress, tie=tie,
        chunk=chunk, checkpoint_dir=checkpoint_dir, resume_from=resume_from,
    )
    image = jnp.asarray(image)
    pad_in = (-W) % nsh
    if pad_in:
        pw = ((0, 0), (0, pad_in)) + ((0, 0),) * (image.ndim - 2)
        image = jnp.pad(image, pw, mode="edge")
    ispec = P(None, axis, None) if image.ndim == 3 else P(None, axis)
    image = jax.device_put(image, NamedSharding(mesh, ispec))
    vmap = res.vmap
    if vmap.shape[1] != image.shape[1]:  # re-pad the (unpadded) vmap
        vmap = jnp.pad(vmap, ((0, 0), (0, image.shape[1] - vmap.shape[1])))
    vmap = jax.device_put(vmap, NamedSharding(mesh, P(None, axis)))

    Wlo = -(-(W + n_seams) // nsh)
    out = jax.jit(shard_map(
        lambda im, vm: _sharded_enlarge(im, vm, n_seams, W, Wlo, axis),
        mesh=mesh, in_specs=(ispec, P(None, axis)), out_specs=ispec,
    ), static_argnames=())(image, vmap)
    return SpatialCarveResult(res.vmap, jnp.asarray(W + n_seams, jnp.int32),
                              out[:, : W + n_seams])


# --------------------------------------------------------------- driver -----

class SpatialCarveResult:
    def __init__(self, vmap, width, image=None):
        self.vmap = vmap
        self.width = width
        self.image = image  # compacted (H, W[, C]); cols >= width are dead


class SpatialCarveState(NamedTuple):
    """Mid-carve sharded state (the checkpointable pytree; all (H, W)-shaped
    leaves carry a NamedSharding over the column axis)."""
    luma: jax.Array     # (H, W) f32, dead region edge-filled
    image: jax.Array    # (H, W[, C]) carried channels, or (1, nsh) dummy
    origcol: jax.Array  # (H, W) i32
    vmap: jax.Array     # (H, W) i32, ORIGINAL coordinates
    energy: jax.Array   # (H, W) f32
    width: jax.Array    # () i32 logical width


@functools.partial(
    jax.jit, static_argnames=("blocksize", "mesh", "axis", "with_image",
                              "logical_width", "energy_fn")
)
def _spatial_init_jit(luma, image, blocksize, edges, textures, mesh, axis,
                      with_image, logical_width=None, energy_fn=None):
    H, W = luma.shape
    if logical_width is None:
        logical_width = W

    spec = P(None, axis)
    energy = shard_map(
        lambda l: _sharded_energy(l, blocksize, edges, textures, W, axis,
                                  energy_fn),
        mesh=mesh, in_specs=(spec,), out_specs=spec,
    )(luma)
    origcol = jax.device_put(
        jnp.broadcast_to(jnp.arange(W, dtype=jnp.int32), (H, W)),
        NamedSharding(mesh, spec))
    vmap0 = jax.device_put(jnp.zeros((H, W), jnp.int32),
                           NamedSharding(mesh, spec))
    return SpatialCarveState(luma, image, origcol, vmap0, energy,
                             jnp.asarray(logical_width, jnp.int32))


@functools.partial(
    jax.jit, static_argnames=("count", "blocksize", "mesh", "axis",
                              "frontier_block", "strip_update", "with_image",
                              "delta_x", "rigidity", "energy_fn", "tie")
)
def _spatial_chunk_jit(state, seam_base, count, blocksize, edges, textures,
                       mesh, axis, frontier_block, strip_update, with_image,
                       delta_x=1, rigidity=0.0, energy_fn=None,
                       tie="leftmost"):
    """Carve `count` seams starting at 1-based label seam_base+1."""
    H, W = state.luma.shape
    nsh = mesh.shape[axis]
    Wl = W // nsh
    K = max(1, min(frontier_block, H))

    def shard_fn(luma_l, img_l, origcol_l, vmap_l, E_l, width0, base):
        lo = _axis_index(axis) * Wl

        def body(i, carry):
            st, recs = carry
            st, orig = _spatial_seam_step(
                st, base + i + 1, blocksize, edges, textures, W, Wl, K,
                strip_update, with_image, axis, delta_x=delta_x,
                rigidity=rigidity, energy_fn=energy_fn, tie=tie,
                defer_record=True,
            )
            return st, jax.lax.dynamic_update_index_in_dim(recs, orig, i, 0)

        st = (luma_l, img_l, origcol_l, vmap_l, E_l, width0[0])
        recs0 = _pvary(jnp.zeros((count, H), jnp.int32), axis)
        st, recs = jax.lax.fori_loop(0, count, body, (st, recs0))
        # vmap records land in ONE scatter per chunk instead of a
        # full-buffer masked write per seam (~0.4 ms/seam at 8K): each
        # removed pixel's original column is unique, so the unordered
        # scatter is exact; out-of-shard columns drop
        luma_l, img_l, origcol_l, vmap_l, E_l, width = st
        rows = jnp.broadcast_to(jnp.arange(H, dtype=jnp.int32)[None, :],
                                (count, H))
        labels = base + 1 + jnp.arange(count, dtype=jnp.int32)[:, None]
        cols = recs - lo
        # negative indices WRAP in jax scatters (only >= Wl drops); send
        # out-of-shard columns to the high OOB sentinel instead
        cols = jnp.where((cols >= 0) & (cols < Wl), cols, Wl)
        vmap_l = vmap_l.at[rows, cols].set(
            jnp.broadcast_to(labels, (count, H)), mode="drop")
        return (luma_l, img_l, origcol_l, vmap_l, E_l, width[None])

    spec = P(None, axis)
    img_spec = (P(None, axis, None)
                if (with_image and state.image.ndim == 3) else spec)
    shard = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(spec, img_spec, spec, spec, spec, P(axis), P(axis)),
        out_specs=(spec, img_spec, spec, spec, spec, P(axis)),
    )
    rep = lambda x: jnp.broadcast_to(jnp.asarray(x, jnp.int32), (nsh,))
    luma, img, origcol, vmap, energy, widths = shard(
        state.luma, state.image, state.origcol, state.vmap, state.energy,
        rep(state.width), rep(seam_base),
    )
    return SpatialCarveState(luma, img, origcol, vmap, energy, widths[0])


def spatial_make_state(
    luma,
    *,
    blocksize: int = 8,
    edges: float = 0.0,
    textures: float = 1.0,
    mesh: Mesh | None = None,
    axis: str = "x",
    image=None,
    energy=None,
):
    """Shard the inputs over `mesh` and compute the initial sharded energy.
    Returns (SpatialCarveState, mesh).

    Widths not divisible by the mesh size are edge-padded to the next
    multiple: the pad columns replicate the last live column, which is
    EXACTLY the dead-region edge-fill invariant the carve maintains after
    every removal — window clamping therefore reads the same values as an
    unpadded single-device buffer, the DP masks the pad to +inf, and seams
    stay bitwise-identical.  The padded buffer width is static; the logical
    width starts at the true W."""
    if mesh is None:
        mesh = make_mesh(axis_name=axis)
    W = luma.shape[1]
    nsh = mesh.shape[axis]
    pad = (-W) % nsh
    luma = jnp.asarray(luma)
    if pad:
        luma = jnp.pad(luma, ((0, 0), (0, pad)), mode="edge")
    luma = jax.device_put(luma, NamedSharding(mesh, P(None, axis)))
    with_image = image is not None
    if with_image:
        image = jnp.asarray(image)
        if pad:
            pw = ((0, 0), (0, pad)) + ((0, 0),) * (image.ndim - 2)
            image = jnp.pad(image, pw, mode="edge")
        ispec = P(None, axis, None) if image.ndim == 3 else P(None, axis)
        image = jax.device_put(image, NamedSharding(mesh, ispec))
    else:
        image = jax.device_put(
            jnp.zeros((1, nsh), luma.dtype), NamedSharding(mesh, P(None, axis))
        )  # placeholder, untouched
    state = _spatial_init_jit(luma, image, blocksize, edges, textures,
                              mesh, axis, with_image, W,
                              energy_fn=resolve_energy(energy))
    return state, mesh


def spatial_carve_n_seams(
    luma,
    n_seams: int,
    *,
    blocksize: int = 8,
    edges: float = 0.0,
    textures: float = 1.0,
    mesh: Mesh | None = None,
    axis: str = "x",
    frontier_block: int = FRONTIER_BLOCK,
    strip_update: bool = True,
    image=None,
    chunk: int = 0,
    checkpoint_dir: str | None = None,
    resume_from: str | None = None,
    delta_x: int = 1,
    rigidity: float = 0.0,
    energy=None,
    progress=None,
    tie: str = "leftmost",
) -> SpatialCarveResult:
    """Carve `n_seams` from one column-sharded image.  `luma` (H, W), any W
    (non-divisible widths are edge-padded internally, see
    `spatial_make_state`).  Returns the visibility map (original coords)
    and final width; seams are identical to the single-device path,
    including the generalized `delta_x`/`rigidity` DP (the
    `lqr_carver_init` parameters, src/render.c:313).

    `energy`: a builtin energy name or ops.energy_fn.EnergyFunction — the
    `lqr_carver_set_energy_function` analog, honored on the sharded path
    exactly like the single-device one (seam-for-seam identical, tested).
    `progress`: an optional utils.progress.Progress (the liblqr progress
    hooks, src/render.c:316): init before the first seam, update(done/total)
    after every chunk, end on completion.  With chunk=0 the whole carve is
    one device program, so the only update is the final 100% — pass
    chunk>0 for mid-carve reporting.

    `image`: optional (H, W[, C]) full-channel plane carried through the
    sharded compaction — the returned `.image` is the carved image (columns
    < width live, sharded like the input), i.e. the sharded analog of
    `ops.carve.reconstruct_removed` without any gather.
    `frontier_block` (K): rows per DP/backtrack collective exchange —
    `collectives_per_seam(H, K)` per seam instead of ~3H.
    `chunk` > 0 runs the seam loop in chunks of that many seams, writing an
    orbax sharded checkpoint to `checkpoint_dir` after each (multi-host
    preemption recovery; `utils.checkpoint.save_sharded`); `resume_from`
    restores one and continues."""
    if mesh is None:
        mesh = make_mesh(axis_name=axis)
    if delta_x < 1:
        raise ValueError(f"delta_x must be >= 1, got {delta_x}")
    from ..ops.dp import check_tie

    check_tie(tie)
    energy_fn = resolve_energy(energy)
    n_eff = energy_fn.n if energy_fn is not None else blocksize
    W = luma.shape[1]
    if W < min_strip_width(n_eff, delta_x,
                           strip_row_block(luma.shape[0], n_eff, delta_x, W)):
        strip_update = False
    with_image = image is not None

    # carve parameters travel with the checkpoint and are validated on
    # resume — resuming with different energy/DP parameters would silently
    # produce mixed-parameter carves (same guard as utils.checkpoint's
    # .npz load_state, which restores its full config)
    params = {
        "blocksize": int(blocksize), "edges": float(edges),
        "textures": float(textures), "frontier_block": int(frontier_block),
        "strip_update": bool(strip_update), "delta_x": int(delta_x),
        "rigidity": float(rigidity),
        # resuming with image=... a checkpoint saved without one (or vice
        # versa) would silently carve the (1, nsh) placeholder; the ndim
        # guards 2-D vs 3-D image planes the same way
        "with_image": bool(with_image),
        "image_ndim": int(np.asarray(image).ndim) if with_image else 0,
        "energy": energy_fn.name if energy_fn is not None else "dct",
        "tie": tie,
    }

    done = 0
    if resume_from is not None:
        from ..utils.checkpoint import load_sharded

        state, meta = load_sharded(resume_from, mesh, axis,
                                   SpatialCarveState)
        done = int(meta["seams_done"])
        if meta["n_seams_total"] != n_seams:
            raise ValueError(
                f"checkpoint was for {meta['n_seams_total']} seams, "
                f"requested {n_seams}")
        mismatched = {k: (meta[k], v) for k, v in params.items()
                      if k in meta and meta[k] != v}
        if mismatched:
            raise ValueError(
                "checkpoint carve parameters do not match the resume "
                f"request: {mismatched} (saved, requested)")
    else:
        state, mesh = spatial_make_state(
            luma, blocksize=blocksize, edges=edges, textures=textures,
            mesh=mesh, axis=axis, image=image, energy=energy_fn,
        )

    if progress is not None:
        from ..utils.i18n import _ as _t

        progress.init(_t("Resizing width..."))
        if done:
            progress.update(done / n_seams)
    step = chunk if chunk > 0 else n_seams
    while done < n_seams:
        count = min(step, n_seams - done)
        state = _spatial_chunk_jit(
            state, jnp.int32(done), count, blocksize, edges, textures,
            mesh, axis, frontier_block, strip_update, with_image,
            delta_x, rigidity, energy_fn, tie,
        )
        state = jax.block_until_ready(state)
        done += count
        if progress is not None:
            progress.update(done / n_seams)
        if checkpoint_dir is not None and done < n_seams:
            from ..utils.checkpoint import save_sharded

            save_sharded(checkpoint_dir, state,
                         {"seams_done": done, "n_seams_total": n_seams,
                          **params})
    if progress is not None:
        progress.end()
    # un-pad: results are reported at the ORIGINAL width
    res_vmap = state.vmap[:, :W] if state.vmap.shape[1] != W else state.vmap
    res_img = None
    if with_image:
        res_img = (state.image[:, :W]
                   if state.image.shape[1] != W else state.image)
    return SpatialCarveResult(res_vmap, state.width, res_img)
