"""What only the card can show: the seam-DP kernel compiled for the GPU at
the deployments' widths, and the fused energy chains' bits.

Every test takes the `gpu` fixture and skips on a host without an NVIDIA
GPU.  On the card they run in `python chip_smoke.py` (phase 6).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dct_carver_tpu import platform
from dct_carver_tpu.ops import dp
from dct_carver_tpu.ops.carve import carve_n_seams, full_energy_map
from dct_carver_tpu.pallas import seam_dp
from dct_carver_tpu.utils.native import carve_native_f32, energy_map_native_f32

pytestmark = pytest.mark.chip


@jax.jit
def _scan_seam(E, width):
    return dp.backtrack(dp.cumulative_energy(dp.mask_energy(E, width)))


@jax.jit
def _scan_seam_right(E, width):
    return dp.backtrack(dp.cumulative_energy(dp.mask_energy(E, width)),
                        tie="rightmost")


def _photo_luma(h, w, seed=5):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = xx * 1.7 + 25 * np.sin(yy / 7.0) + 20 * np.cos(xx / 11.0)
    img = img + 70 * (((xx // 53 + yy // 41) % 4) == 0)
    img = img + rng.normal(0, 5, size=(h, w))
    return ((img % 256) / 255.0).astype(np.float32)


def test_platform_picks_the_kernel(gpu):
    assert platform.seam_dp_kernel(1920)


@pytest.mark.parametrize("kind", ["random", "quantized"])
@pytest.mark.parametrize("tie", ["leftmost", "rightmost"])
@pytest.mark.parametrize("hw", [(1080, 1920), (3808, 2160), (2160, 3840)])
def test_kernel_bitwise_scan_at_real_widths(gpu, hw, tie, kind):
    H, W = hw
    rng = np.random.default_rng(H + W)
    E = rng.random((H, W)).astype(np.float32)
    if kind == "quantized":
        E = (np.floor(E * 3) / 3).astype(np.float32)
    E = jnp.asarray(E)
    scan = _scan_seam if tie == "leftmost" else _scan_seam_right
    for width in (W, W - 97):
        w = jnp.int32(width)
        np.testing.assert_array_equal(
            np.asarray(seam_dp.find_seam(E, w, tie=tie)),
            np.asarray(scan(E, w)), err_msg=f"width={width}")


def test_kernel_batched_bitwise_scan(gpu):
    B, H, W = 16, 1024, 1024
    rng = np.random.default_rng(16)
    E = jnp.asarray(rng.random((B, H, W)).astype(np.float32))
    widths = jnp.asarray(rng.integers(W - 128, W + 1, B), jnp.int32)
    got = jax.jit(jax.vmap(lambda e, w: seam_dp.find_seam(e, w)))(E, widths)
    ref = jax.jit(jax.vmap(_scan_seam))(E, widths)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_fused_energy_bitwise_native(gpu, n):
    """XLA:GPU fuses the multiply-add chains without contracting them into
    FMAs: the energy is bitwise the native f32-chain energy."""
    luma = _photo_luma(540, 960)
    got = np.asarray(jax.jit(
        lambda l: full_energy_map(l, n, 0.3, 0.7))(jnp.asarray(luma)))
    np.testing.assert_array_equal(got, energy_map_native_f32(luma, n, 0.3,
                                                             0.7))


@pytest.mark.parametrize("tie", ["leftmost", "rightmost"])
def test_carve_identical_to_native(gpu, tie):
    luma = _photo_luma(540, 960, seed=6)
    st = carve_n_seams(jnp.asarray(luma), 48, 8, 0.3, 0.7, tie=tie)
    np.testing.assert_array_equal(
        np.asarray(st.vmap), carve_native_f32(luma, 48, 8, 0.3, 0.7, tie=tie))
