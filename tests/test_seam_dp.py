"""The seam-DP kernel (pallas/seam_dp.py) against XLA's scan — bitwise.

On a host without a GPU the kernel runs through the Pallas interpreter
(`interpret=True`); the same kernel compiled for the card is checked at real
widths by tests/test_chip.py.
"""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dct_carver_tpu.ops import dp
from dct_carver_tpu.ops.carve import carve_n_seams, find_seam
from dct_carver_tpu.pallas import seam_dp


def _scan_seam(E, width, tie="leftmost"):
    return dp.backtrack(dp.cumulative_energy(dp.mask_energy(E, width)),
                        tie=tie)


def _energy(rng, shape, kind):
    if kind == "random":
        return rng.random(shape).astype(np.float32)
    # quantized: exact ties everywhere in the DP and the last-row argmin
    return (rng.integers(0, 3, size=shape) / 3.0).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "quantized"])
@pytest.mark.parametrize("tie", ["leftmost", "rightmost"])
@pytest.mark.parametrize("hw", [(16, 128), (40, 256), (33, 61), (24, 200)])
def test_kernel_matches_scan(hw, tie, kind, rng):
    """Power-of-two and odd widths, full and masked logical widths."""
    H, W = hw
    E = jnp.asarray(_energy(rng, (H, W), kind))
    for width in (W, max(2, W * 3 // 5)):
        w = jnp.int32(width)
        got = seam_dp.find_seam(E, w, tie=tie, interpret=True)
        np.testing.assert_array_equal(np.asarray(got),
                                      np.asarray(_scan_seam(E, w, tie)),
                                      err_msg=f"width={width}")


@pytest.mark.parametrize("hw", [(1, 17), (2, 2), (5, 3)])
def test_kernel_degenerate_shapes(hw, rng):
    """One row (no recurrence), two columns, three columns."""
    H, W = hw
    E = jnp.asarray(rng.random((H, W)).astype(np.float32))
    for tie in ("leftmost", "rightmost"):
        got = seam_dp.find_seam(E, jnp.int32(W), tie=tie, interpret=True)
        np.testing.assert_array_equal(np.asarray(got),
                                      np.asarray(_scan_seam(E, W, tie)))


def test_kernel_inf_energy_region(rng):
    """Energies that are already +inf (a dead region written by the carve)
    behave like masked columns."""
    H, W = 20, 96
    E = rng.random((H, W)).astype(np.float32)
    E[:, 70:] = np.inf
    E = jnp.asarray(E)
    got = seam_dp.find_seam(E, jnp.int32(W), interpret=True)
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(_scan_seam(E, W)))
    assert int(np.max(np.asarray(got))) < 70


@pytest.mark.parametrize("tie", ["leftmost", "rightmost"])
def test_kernel_vmap_is_one_program_per_image(tie, rng):
    """Under vmap the batch becomes the kernel's grid; each image keeps its
    own logical width."""
    B, H, W = 4, 24, 100
    E = jnp.asarray(_energy(rng, (B, H, W), "quantized"))
    widths = jnp.asarray([W, 77, 31, 2], jnp.int32)
    got = jax.jit(jax.vmap(
        lambda e, w: seam_dp.find_seam(e, w, tie=tie, interpret=True)
    ))(E, widths)
    for i in range(B):
        np.testing.assert_array_equal(
            np.asarray(got[i]), np.asarray(_scan_seam(E[i], widths[i], tie)))


def test_kernel_jaxpr_grid_under_vmap():
    """The batched call lowers to ONE pallas_call whose grid is the batch."""
    f = jax.vmap(lambda e, w: seam_dp.find_seam(e, w, interpret=True))
    jaxpr = jax.make_jaxpr(f)(jnp.zeros((3, 8, 40), jnp.float32),
                              jnp.full((3,), 40, jnp.int32))
    text = str(jaxpr)
    assert text.count("pallas_call") == 1
    assert "grid=(3,)" in text


@pytest.mark.parametrize("shape", [(1080, 1920), (3840, 2160), (2160, 3840),
                                   (64, 7680), (16, 1024, 1024)])
def test_kernel_lowers_through_triton(shape):
    """The kernel at the real widths lowers to Triton IR for CUDA (JAX does
    this lowering itself, so it needs no GPU; compiling the IR does, and
    tests/test_chip.py covers that on the card)."""
    *B, H, W = shape
    f = lambda e, w: seam_dp.find_seam(e, w)
    for _ in B:
        f = jax.vmap(f)
    lowered = jax.jit(f).trace(
        jax.ShapeDtypeStruct(tuple(shape), jnp.float32),
        jax.ShapeDtypeStruct(tuple(B), jnp.int32),
    ).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert text.count("__gpu$xla.gpu.triton") == 1
    assert f"grid_x = {B[0] if B else 1} : i32" in text


@pytest.mark.parametrize("warps", [None, 8, 16])
def test_seam_call_warps_reach_triton(warps):
    """`find_seam` lowers at `num_warps(W)`; `seam_call` (the warps sweep's
    entry) at the warps it is given, with the same seams."""
    H, W = 1080, 1920
    if warps is None:
        f, want = (lambda w, e: seam_dp.find_seam(e.reshape(H, W), w[0]),
                   seam_dp.num_warps(W))
    else:
        f, want = seam_dp.seam_call(H, W, "leftmost", warps), warps
    text = jax.jit(f).trace(
        jax.ShapeDtypeStruct((1,), jnp.int32),
        jax.ShapeDtypeStruct((H * W,), jnp.float32),
    ).lower(lowering_platforms=("cuda",)).as_text()
    assert re.findall(r"num_warps = (\d+) : i32", text) == [str(want)]


def test_seam_call_interpret_matches_find_seam(rng):
    H, W = 12, 50
    E = jnp.asarray(rng.random((H, W)).astype(np.float32))
    _, seam, _ = seam_dp.seam_call(H, W, "rightmost", 8, interpret=True)(
        jnp.asarray([37], jnp.int32), E.reshape(H * W))
    np.testing.assert_array_equal(
        np.asarray(seam),
        np.asarray(seam_dp.find_seam(E, jnp.int32(37), tie="rightmost",
                                     interpret=True)))


@pytest.mark.parametrize("W,bw,warps", [(2, 2, 4), (61, 64, 4), (128, 128, 4),
                                        (1024, 1024, 16), (1920, 2048, 32),
                                        (2160, 4096, 32), (7680, 8192, 32)])
def test_block_width_and_warps(W, bw, warps):
    assert seam_dp.block_width(W) == bw
    assert seam_dp.num_warps(W) == warps


@pytest.mark.parametrize("tie", ["leftmost", "rightmost"])
def test_parent_select_matches_window_argmin(tie):
    """The vectorized parent rule equals the scan's argmin over the window
    [left, center, right] on every ordering with ties."""
    vals = np.array([0.0, 1.0, np.inf], np.float32)
    l, c, r = (a.ravel() for a in np.meshgrid(vals, vals, vals,
                                              indexing="ij"))
    got = np.asarray(seam_dp.parent_select(jnp.asarray(l), jnp.asarray(c),
                                           jnp.asarray(r),
                                           tie == "rightmost"))
    win = jnp.stack([jnp.asarray(l), jnp.asarray(c), jnp.asarray(r)], 1)
    ref = np.asarray(jax.vmap(lambda x: dp._argmin_tie(x, tie))(win)) - 1
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("tie", ["leftmost", "rightmost"])
@pytest.mark.parametrize("strip", [True, False])
def test_full_carve_kernel_matches_scan(tie, strip, rng):
    """The whole carve with the kernel as its DP equals the scan carve:
    visibility map, final energy and luma."""
    H, W = 32, 200
    luma = jnp.asarray(rng.random((H, W)).astype(np.float32))
    scan = carve_n_seams(luma, 6, 8, 0.3, 0.8, strip_update=strip, tie=tie)
    kern = carve_n_seams(luma, 6, 8, 0.3, 0.8, strip_update=strip, tie=tie,
                         interpret=True)
    np.testing.assert_array_equal(np.asarray(scan.vmap),
                                  np.asarray(kern.vmap))
    np.testing.assert_array_equal(np.asarray(scan.energy),
                                  np.asarray(kern.energy))
    np.testing.assert_array_equal(np.asarray(scan.luma),
                                  np.asarray(kern.luma))


def test_vmapped_full_carve_kernel_matches_per_image(rng):
    """The batch route's form: vmap of the whole carve, kernel DP inside."""
    B, H, W, n = 3, 16, 96, 4
    lumas = jnp.asarray(rng.random((B, H, W)).astype(np.float32))
    batched = jax.jit(jax.vmap(
        lambda l: carve_n_seams(l, n, 8, 0.3, 0.8, interpret=True)))(lumas)
    for i in range(B):
        ref = carve_n_seams(lumas[i], n, 8, 0.3, 0.8)
        np.testing.assert_array_equal(np.asarray(batched.vmap[i]),
                                      np.asarray(ref.vmap))
        assert int(batched.width[i]) == W - n


def test_find_seam_generalized_dp_stays_on_scan(rng):
    """delta_x != 1 or rigidity != 0 is not the kernel's recurrence: the
    dispatcher keeps the scan even when the kernel is asked for."""
    E = jnp.asarray(rng.random((12, 40)).astype(np.float32))
    w = jnp.int32(40)
    for dx, rig in ((2, 0.0), (1, 0.5)):
        ref = dp.backtrack(dp.cumulative_energy(dp.mask_energy(E, w), dx,
                                                rig), dx, rig)
        got = find_seam(E, w, dx, rig, interpret=True)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
        text = str(jax.make_jaxpr(
            lambda e: find_seam(e, w, dx, rig, interpret=True))(E))
        assert "pallas_call" not in text
