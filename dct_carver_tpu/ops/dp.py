"""Seam dynamic programming + seam removal/insertion ops (single device).

A recast of the liblqr carving engine's core (the external `lqr-1` library
behind `/root/reference/src/render.c:312-315,377`) as array programs:

* Cumulative energy ``M[i,j] = E[i,j] + min(M[i-1,j-1], M[i-1,j], M[i-1,j+1])``
  (delta_x=1, rigidity=0 per `src/render.c:313`) as a `lax.scan` over rows —
  each step is one fused pass over the row; no per-pixel callbacks.  On a
  GPU the carve runs this DP as one kernel instead (`pallas/seam_dp.py`,
  chosen by `dct_carver_tpu.platform`); these scans stay the semantics
  anchor it is tested against.
* Backtracking as a reverse `lax.scan` with a 3-wide dynamic slice per row.
* Seam removal as a branch-free select-shift compaction (no gathers in the
  inner loop) over a static-width buffer with a dynamic logical width —
  XLA-friendly static shapes for the whole multi-seam carve loop.

Tie conventions (identical to oracle/reference.py): the `tie` knob picks the
leftmost (default) or rightmost argmin at the last row AND among the
backtrack candidates.  The real convention lives inside external liblqr
(unobservable in this environment — docs/PARITY.md S1/S2); making it a knob
applied identically in every path (oracle, native C++, scan, GPU kernel,
spatial) means whichever convention real liblqr has, the framework can match
it with a flag.

All functions are shape-polymorphic pure functions, safe under jit/vmap.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "cumulative_energy",
    "backtrack",
    "find_seam",
    "remove_seam",
    "mask_energy",
    "check_tie",
    "TIES",
]


TIES = ("leftmost", "rightmost")


def check_tie(tie: str) -> str:
    if tie not in TIES:
        raise ValueError(f"tie must be one of {TIES}, got {tie!r}")
    return tie


def _argmin_tie(x: jax.Array, tie: str) -> jax.Array:
    """Index of the minimum of a 1-D array; ties resolved per `tie`
    (jnp.argmin alone is the leftmost convention)."""
    if tie == "leftmost":
        return jnp.argmin(x).astype(jnp.int32)
    n = x.shape[0]
    return (n - 1 - jnp.argmin(x[::-1])).astype(jnp.int32)


def _rigidity_penalties(delta_x: int, rigidity: float, dtype):
    """Per-step-offset penalty, this framework's spec of liblqr's
    `lqr_carver_init(delta_x, rigidity)` generalization: a seam may move up
    to `delta_x` columns per row, and a step of |dx| costs
    ``rigidity * |dx| / delta_x``.  The reference plugin always runs
    (delta_x=1, rigidity=0) (`src/render.c:313`) — the parity-tested config —
    where this reduces exactly to the classic 3-candidate recurrence."""
    return [rigidity * abs(dx) / delta_x for dx in range(-delta_x, delta_x + 1)]


def _shift_row(row: jax.Array, dx: int, inf) -> jax.Array:
    """row shifted so index j holds row[j + dx]; vacated slots are +inf."""
    if dx == 0:
        return row
    if dx < 0:
        return jnp.concatenate([jnp.broadcast_to(inf, (-dx,)), row[:dx]])
    return jnp.concatenate([row[dx:], jnp.broadcast_to(inf, (dx,))])


def cumulative_energy(E: jax.Array, delta_x: int = 1,
                      rigidity: float = 0.0) -> jax.Array:
    """(H, W) energy -> (H, W) DP cumulative energy.  At the default
    (delta_x=1, rigidity=0) this matches the oracle bitwise given
    bitwise-equal inputs (same op order: E + min(min(left, center), right));
    see `_rigidity_penalties` for the generalized recurrence."""
    dtype = E.dtype
    inf = jnp.asarray(jnp.inf, dtype)
    pen = _rigidity_penalties(delta_x, rigidity, dtype)

    def step(prev, e_row):
        # leftmost-first candidate order; ties resolved by the backtrack
        best = None
        for k, dx in enumerate(range(-delta_x, delta_x + 1)):
            cand = _shift_row(prev, dx, inf)
            if pen[k] != 0.0:
                cand = cand + dtype.type(pen[k])
            best = cand if best is None else jnp.minimum(best, cand)
        m = e_row + best
        return m, m

    m0 = E[0]
    _, rest = jax.lax.scan(step, m0, E[1:])
    return jnp.concatenate([m0[None], rest], axis=0)


def backtrack(M: jax.Array, delta_x: int = 1,
              rigidity: float = 0.0, tie: str = "leftmost") -> jax.Array:
    """(H, W) cumulative energy -> (H,) int32 seam columns.  Ties pick the
    `tie`-most minimum among the 2*delta_x+1 (penalized) candidates (and of
    the last row)."""
    H, W = M.shape
    dtype = M.dtype
    check_tie(tie)
    k = 2 * delta_x + 1
    Mp = jnp.pad(M, ((0, 0), (delta_x, delta_x)), constant_values=jnp.inf)
    pen = jnp.asarray(_rigidity_penalties(delta_x, rigidity, dtype), dtype)
    j_last = _argmin_tie(M[-1], tie)

    def step(j, row_p):
        # padded window [j-delta_x .. j+delta_x]; borders +inf, never chosen
        win = jax.lax.dynamic_slice(row_p, (j,), (k,))
        if rigidity != 0.0:
            win = win + pen
        j_new = j - delta_x + _argmin_tie(win, tie)
        return j_new, j_new

    _, seam_rev = jax.lax.scan(step, j_last, Mp[:-1][::-1])
    return jnp.concatenate([seam_rev[::-1], j_last[None]])


def find_seam(E: jax.Array, delta_x: int = 1, rigidity: float = 0.0,
              tie: str = "leftmost") -> jax.Array:
    return backtrack(cumulative_energy(E, delta_x, rigidity), delta_x,
                     rigidity, tie)


def mask_energy(E: jax.Array, width: jax.Array) -> jax.Array:
    """+inf beyond the logical width so DP never enters the dead region."""
    col = jnp.arange(E.shape[1])
    return jnp.where(col[None, :] < width, E, jnp.inf).astype(E.dtype)


def remove_seam(arr: jax.Array, seam: jax.Array) -> jax.Array:
    """Compact one pixel per row out of a static-width buffer.

    arr: (H, W[, C]); seam: (H,) int32.  Column j of the result is arr[:, j]
    for j < seam and arr[:, j+1] for j >= seam; the last column is garbage
    (it falls in the caller's dead region).  Branch-free: one roll + select.
    """
    W = arr.shape[1]
    shifted = jnp.roll(arr, -1, axis=1)
    keep = jnp.arange(W)[None, :] < seam[:, None]
    if arr.ndim == 3:
        keep = keep[..., None]
    return jnp.where(keep, arr, shifted)
