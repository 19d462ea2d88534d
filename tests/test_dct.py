"""DCT convention + energy-map tests vs the NumPy oracle and scipy."""

import numpy as np
import pytest
import scipy.fft

import jax
import jax.numpy as jnp

from dct_carver_tpu.oracle import reference as oracle
from dct_carver_tpu.ops.dct import dct_energy_map, dct_matrix
from dct_carver_tpu.ops.energy import energy_map, to_luma, normalize_to_u8


@pytest.mark.parametrize("n", [8, 16])
def test_dct_matrix_orthonormal_matches_scipy(n, rng):
    """N=8,16 use Ooura's normalized DCT == scipy dctn(norm='ortho')
    (src/fft2d/shrtdct.c:190-205)."""
    D = oracle.dct_matrix_reference(n)
    block = rng.random((n, n))
    ours = D @ block @ D.T
    ref = scipy.fft.dctn(block, norm="ortho")
    np.testing.assert_allclose(ours, ref, atol=1e-12)


@pytest.mark.parametrize("n", [2, 4])
def test_dct_matrix_unnormalized_convention(n, rng):
    """N=2,4 use ddct2d case 2: C[k1,k2] = sum a cos(pi(j1+.5)k1/n) cos(...)
    (src/fft2d/fftsg2d.c:200-211) — no normalization factors."""
    D = oracle.dct_matrix_reference(n)
    block = rng.random((n, n))
    ours = D @ block @ D.T
    # brute force the definition
    ref = np.zeros((n, n))
    for k1 in range(n):
        for k2 in range(n):
            for j1 in range(n):
                for j2 in range(n):
                    ref[k1, k2] += (
                        block[j1, j2]
                        * np.cos(np.pi * (j1 + 0.5) * k1 / n)
                        * np.cos(np.pi * (j2 + 0.5) * k2 / n)
                    )
    np.testing.assert_allclose(ours, ref, atol=1e-12)
    # and it must differ from the orthonormal one (the argmax depends on it)
    assert not np.allclose(ours, scipy.fft.dctn(block, norm="ortho"))


@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_jax_dct_matrix_matches_oracle(n):
    # enable_x64 so the comparison really runs at f64 (outside it the jnp
    # matrix silently truncates to f32 with a warning)
    with jax.enable_x64(True):
        got = np.asarray(dct_matrix(n, jnp.float64))
    np.testing.assert_allclose(got, oracle.dct_matrix_reference(n), atol=1e-15)


@pytest.mark.parametrize("n", [2, 4, 8, 16])
@pytest.mark.parametrize("kind", ["random", "gradient", "flat", "edges"])
def test_energy_map_matches_oracle_f64(n, kind, make_image):
    """JAX energy (f64) vs oracle: near-exact values, identical weight classes."""
    img = make_image(24, 31, kind=kind)
    luma = oracle.luma_bt709(img)
    ref = oracle.energy_map(luma, n, edges=0.3, textures=0.9)
    with jax.enable_x64(True):
        got = dct_energy_map(jnp.asarray(luma, jnp.float64), n, 0.3, 0.9)
    # the oracle's output is spec'd as f32 (gfloat, src/dct.c:96); compare
    # after the same downcast — any weight-class (edges/textures) mismatch
    # would show up as a large relative error, far above 1 ulp
    np.testing.assert_allclose(
        np.asarray(got, np.float32), ref, rtol=3e-7, atol=1e-12
    )


@pytest.mark.parametrize("n", [4, 8])
def test_energy_map_f32_close(n, make_image):
    img = make_image(32, 40, c=3)
    luma32 = np.asarray(oracle.luma_bt709(img), np.float32)
    ref = oracle.energy_map(oracle.luma_bt709(img), n, 0.5, 0.5)
    got = dct_energy_map(jnp.asarray(luma32), n, 0.5, 0.5)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=2e-4, atol=2e-5)


def test_energy_row_block_equivalence(make_image):
    img = make_image(32, 21, c=3)
    luma = to_luma(jnp.asarray(img))
    full = dct_energy_map(luma, 8, 0.2, 0.8)
    blocked = dct_energy_map(luma, 8, 0.2, 0.8, row_block=8)
    # CPU LLVM contracts mul+add chains to FMA differently across fusion
    # contexts (lax.map body vs eager) — tight allclose there; XLA:GPU does
    # not contract them (docs/PARITY.md, tests/test_chip.py)
    np.testing.assert_allclose(
        np.asarray(full), np.asarray(blocked), rtol=5e-5, atol=1e-7
    )


def test_edge_weighting_discriminates():
    """A vertical step edge must be weighted by `edges`, textures by `textures`."""
    h = w = 16
    col = (np.arange(w) >= w // 2).astype(np.float64)
    luma = np.tile(col, (h, 1)) * 0.8
    e_edges = oracle.energy_map(luma, 8, edges=1.0, textures=0.0)
    e_tex = oracle.energy_map(luma, 8, edges=0.0, textures=1.0)
    center = e_edges[8, 7:9]
    assert center.max() > 0.1  # edge energy present with edge weight
    assert e_tex[8, 7:9].max() < center.max()


def test_luma_modes(make_image):
    img = make_image(8, 9, c=3)
    with jax.enable_x64(True):
        l709 = np.asarray(to_luma(jnp.asarray(img), "bt709", jnp.float64))
        l601 = np.asarray(to_luma(jnp.asarray(img), "bt601_studio", jnp.float64))
    np.testing.assert_allclose(l709, oracle.luma_bt709(img), atol=1e-12)
    np.testing.assert_allclose(l601, oracle.luma_bt601_studio(img), atol=1e-12)


def test_normalize_to_u8(make_image):
    img = make_image(16, 16)
    e = oracle.energy_map(oracle.luma_bt709(img), 8, 0.0, 1.0)
    ours = np.asarray(normalize_to_u8(jnp.asarray(e)))
    np.testing.assert_array_equal(ours, oracle.normalize_to_u8(e))


def test_energy_map_rgb_api(make_image):
    img = make_image(16, 16, c=3)
    e = energy_map(jnp.asarray(img), blocksize=4, edges=0.1, textures=0.9)
    assert e.shape == (16, 16)
    assert np.isfinite(np.asarray(e)).all()


@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_preview_centering_matches_oracle(n, make_image):
    """Preview path: BT.601-studio luma + its own window centering
    (src/render.c:421-479, src/dct.h:8-9)."""
    img = make_image(20, 26, c=3)
    luma = oracle.luma_bt601_studio(img)
    ref = oracle.energy_map(luma, n, 0.4, 0.6, center="preview")
    with jax.enable_x64(True):
        got = dct_energy_map(
            jnp.asarray(luma, jnp.float64), n, 0.4, 0.6, center="preview"
        )
    np.testing.assert_allclose(
        np.asarray(got, np.float32), ref, rtol=3e-7, atol=1e-12
    )


def test_preview_differs_from_carve_center(make_image):
    """The two reference energy paths differ (SURVEY §3.2) — assert we
    reproduce that difference rather than silently unifying geometry."""
    img = make_image(24, 24)
    luma = oracle.luma_bt709(img)
    a = oracle.energy_map(luma, 8, 0.0, 1.0, center="carve")
    b = oracle.energy_map(luma, 8, 0.0, 1.0, center="preview")
    assert not np.array_equal(a, b)
    # preview at (y,x) == carve at (y+1,x+1) in the interior (pure shift)
    np.testing.assert_allclose(b[4:-8, 4:-8], a[5:-7, 5:-7], rtol=1e-6)


def test_carver_energy_preview_api(make_image):
    from dct_carver_tpu.models.carver import Carver
    from dct_carver_tpu.utils.config import CarverConfig

    img = make_image(16, 18, c=3)
    e = Carver(img, CarverConfig(blocksize=4)).energy_preview()
    ref = oracle.normalize_to_u8(
        oracle.energy_map(oracle.luma_bt601_studio(img), 4, 0.0, 1.0,
                          center="preview")
    )
    assert np.abs(e.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_stage2_formulations_bitwise_equal(rng, dtype):
    """Column-chunked evaluation of energy_from_bands must be bitwise equal
    to one wide evaluation (eager dispatch both sides — exact chains); the
    carve loop relies on it (strip vs full recompute)."""
    import jax
    from dct_carver_tpu.ops.dct import rows_to_bands, energy_from_bands

    n = 8
    with jax.enable_x64(dtype == "float64"):
        luma = jnp.asarray(rng.random((24, 600)), dtype=dtype)
        bands = rows_to_bands(luma, n)  # Cout = 600 > 512 -> looped
        wide = energy_from_bands(bands, n, 0.3, 0.9)
        # narrow chunks (Cout <= 512 -> flat) over the same columns
        parts = [
            energy_from_bands(bands[:, :, c : c + 300 + n - 1], n, 0.3, 0.9)
            for c in range(0, 600, 300)
        ]
        narrow = jnp.concatenate(parts, axis=1)
    np.testing.assert_array_equal(np.asarray(wide), np.asarray(narrow))
