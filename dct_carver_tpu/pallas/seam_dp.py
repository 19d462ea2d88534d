"""The per-seam DP as one GPU kernel (Pallas through Triton).

XLA runs `ops/dp.py` as two serial row loops per seam: the forward scan and
the backtrack, H-1 dependent steps each, every step a few small kernels on
one row.  On a GPU each step costs launch latency, not bandwidth.  Here one
program walks all rows of one image:

* the energy row for i+1 is loaded while row i is computed;
* the frontier row M[i-1] is stored into one of two slots of a global
  buffer and re-read at offsets -1, 0, +1 (Triton has no register shift),
  with one block barrier per row; each slot keeps +inf in the cells around
  the row, the borders of the recurrence;
* each row stores int8 parent directions (-1/0/+1), not f32 M;
* after a barrier, the backtrack walks the parents bottom-up, one scalar
  load per row (the parents of a 1080p image are 2 MB and sit in L2).

The arithmetic is that of `ops/dp.py` at delta_x=1, rigidity=0: the same
f32 order `E + min(min(left, center), right)`, +inf beyond the logical
width, and the `tie` rule both at the last-row argmin and in every parent
choice, so seams are bitwise those of the scan.  Under `jax.vmap` the batch
becomes the grid: one program per image.

Reference analog: the DP inside liblqr's `lqr_carver_resize`
(`src/render.c:377`, delta_x=1 rigidity=0 per `:313`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

__all__ = ["find_seam", "seam_call", "block_width", "num_warps"]


def block_width(W: int) -> int:
    """Power-of-two row block covering W columns (Triton blocks are 2^k)."""
    return max(2, 1 << (W - 1).bit_length())


def num_warps(W: int) -> int:
    """Warps per program: two floats of each row per thread up to the
    1024-thread limit.  The row recurrence is latency-bound, so more threads
    per row are faster: on an H100, 32 warps were the fastest of 4-32 at
    W = 1024, 1920 and 3840 (`scripts/compare_dp.py --warps`, PERF.md).  The
    16 warps this rule gives at W = 1024 are not yet re-tuned."""
    return min(32, max(4, block_width(W) // 64))


def parent_select(left, center, right, rightmost: bool):
    """Parent direction (-1/0/+1) of the `tie`-most minimum of the three
    candidates: the decision `ops.dp._argmin_tie` makes over the window
    [left, center, right]."""
    if not rightmost:
        return jnp.where(
            left <= center,
            jnp.where(left <= right, -1, 1),
            jnp.where(center <= right, 0, 1),
        )
    return jnp.where(
        right <= center,
        jnp.where(right <= left, 1, -1),
        jnp.where(center <= left, 0, -1),
    )


def _make_kernel(H: int, W: int, BW: int, rightmost: bool, interpret: bool):
    def barrier():
        # the interpreter runs a program sequentially: nothing to order
        if not interpret:
            plt.debug_barrier()

    def kernel(width_ref, e_ref, parents_ref, seam_ref, rows_ref):
        width = width_ref[0]
        cols = jax.lax.broadcasted_iota(jnp.int32, (BW,), 0)
        live = cols < width
        inf = jnp.float32(jnp.inf)

        def energy_row(i):
            return plt.load(e_ref.at[pl.ds(i * W, BW)], mask=live, other=inf)

        # two frontier slots of 2*BW floats; slot s holds M[i] at
        # [s*2BW + 1, s*2BW + BW + 1) between +inf borders
        infs = jnp.full((BW,), inf, jnp.float32)
        for k in range(4):
            plt.store(rows_ref.at[pl.ds(k * BW, BW)], infs)
        barrier()
        m0 = energy_row(0)
        plt.store(rows_ref.at[pl.ds(1, BW)], m0)

        def row(i, carry):
            # M[i-1] sits in slot `src`; M[i] goes to slot `dst`
            e, _, src, dst = carry
            e_next = energy_row(jnp.minimum(i + 1, H - 1))
            barrier()
            left = plt.load(rows_ref.at[pl.ds(src, BW)])
            center = plt.load(rows_ref.at[pl.ds(src + 1, BW)])
            right = plt.load(rows_ref.at[pl.ds(src + 2, BW)])
            # same op order as ops/dp.py: E + min(min(left, center), right)
            m = e + jnp.minimum(jnp.minimum(left, center), right)
            p = parent_select(left, center, right, rightmost)
            plt.store(rows_ref.at[pl.ds(dst + 1, BW)], m)
            plt.store(parents_ref.at[pl.ds(i * W, BW)], p.astype(jnp.int8),
                      mask=cols < W)
            return e_next, m, dst, src

        e1 = energy_row(min(1, H - 1))
        _, m_last, _, _ = jax.lax.fori_loop(
            1, H, row, (e1, m0, jnp.int32(0), jnp.int32(2 * BW)))

        mn = jnp.min(m_last)
        if rightmost:
            j = jnp.max(jnp.where(m_last == mn, cols, -1))
        else:
            j = jnp.min(jnp.where(m_last == mn, cols, BW))
        barrier()

        def back(k, j):
            i = H - 1 - k
            seam_ref[i] = j
            return j + parents_ref[i * W + j].astype(jnp.int32)

        seam_ref[0] = jax.lax.fori_loop(0, H - 1, back, j)

    return kernel


def seam_call(H: int, W: int, tie: str, warps: int, interpret: bool = False):
    """The kernel's `pallas_call` for (H*W,) f32 energy at `warps` warps:
    (width (1,) i32, energy) -> (parents, seam, frontier slots).  The carve
    reaches it only through `find_seam`, at `num_warps(W)`; a warps sweep
    (`scripts/compare_dp.py --warps`) calls it directly."""
    BW = block_width(W)
    return pl.pallas_call(
        _make_kernel(H, W, BW, tie == "rightmost", interpret),
        out_shape=[
            jax.ShapeDtypeStruct((H * W,), jnp.int8),       # parents
            jax.ShapeDtypeStruct((H,), jnp.int32),          # seam
            jax.ShapeDtypeStruct((4 * BW,), jnp.float32),   # frontier slots
        ],
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=warps,
            # no software pipelining: the frontier loads must stay behind
            # the row barrier
            num_stages=1),
        interpret=interpret,
        name="seam_dp",
    )


@functools.partial(jax.jit, static_argnames=("tie", "interpret"))
def find_seam(E: jax.Array, width: jax.Array, *, tie: str = "leftmost",
              interpret: bool = False) -> jax.Array:
    """(H, W) f32 energy, () i32 logical width -> (H,) i32 seam.

    Columns >= width are +inf to the DP (the carve's dead region).  Bitwise
    equal to `ops.dp.backtrack(ops.dp.cumulative_energy(mask_energy(E,
    width)), tie=tie)`.  `interpret=True` runs the Pallas interpreter (tests
    on hosts without a GPU)."""
    H, W = E.shape
    _, seam, _ = seam_call(H, W, tie, num_warps(W), interpret)(
        jnp.reshape(width, (1,)).astype(jnp.int32),
        E.astype(jnp.float32).reshape(H * W))
    return seam
