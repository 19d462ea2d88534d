"""Pluggable energy functions (ops/energy_fn.py) — the vectorized analog of
liblqr's lqr_carver_set_energy_function / lqr_rwindow_read surface
(/root/reference/src/render.c:314-315, :144-151).

Checks: builtin gradient energies vs an independent NumPy spec, the custom
per-window callback's tap layout (incl. border clamping), strip == full
exactness for plugged energies, end-to-end carve parity with an oracle DP
driven by the same energy, and config/API/checkpoint integration.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dct_carver_tpu.ops.energy_fn import (
    EnergyFunction, GRAD_XABS, GRAD_SUMABS, GRAD_NORM, ENERGY_NULL,
    builtin_energy, custom_energy, resolve_energy,
)
from dct_carver_tpu.ops.carve import carve_n_seams, full_energy_map
from dct_carver_tpu.oracle import reference as oracle


def _rand_luma(h, w, seed=0):
    return np.random.default_rng(seed).random((h, w), dtype=np.float32)


@pytest.mark.parametrize("fn,kind", [
    (GRAD_XABS, "grad_xabs"),
    (GRAD_SUMABS, "grad_sumabs"),
    (GRAD_NORM, "grad_norm"),
    (ENERGY_NULL, "null"),
])
def test_builtin_gradients_match_numpy_spec(fn, kind):
    luma = _rand_luma(37, 53)
    got = np.asarray(jax.jit(fn.energy_map)(jnp.asarray(luma)))
    want = oracle.gradient_energy_map(luma, kind)
    if kind == "grad_norm":
        # XLA contracts dx*dx + dy*dy into an FMA -> up to 1 ulp vs NumPy
        np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
    else:
        # forward diffs / abs / *0.5 are exactly-rounded f32 ops -> bitwise
        np.testing.assert_array_equal(got, want)


def test_custom_energy_center_tap_is_identity():
    """block_fn reading the center tap (r-1, r-1) must return the pixel itself
    — pins the window layout documented in custom_energy."""
    luma = _rand_luma(20, 31, seed=1)
    for radius in (1, 2, 4):
        fn = custom_energy(radius, lambda w, r=radius: w[r - 1, r - 1])
        got = np.asarray(jax.jit(fn.energy_map)(jnp.asarray(luma)))
        np.testing.assert_array_equal(got, luma)


def test_custom_energy_border_clamp_matches_reference_window():
    """Tap (dy, dx) = (0, 0) reads offset (-(r-1), -(r-1)) with edge clamping
    (src/render.c:146-151 reading-window semantics)."""
    luma = _rand_luma(16, 19, seed=2)
    radius = 2  # n = 4, offset -(r-1) = -1
    fn = custom_energy(radius, lambda w: w[0, 0])
    got = np.asarray(jax.jit(fn.energy_map)(jnp.asarray(luma)))
    want = luma[np.maximum(np.arange(16) - 1, 0)][:, np.maximum(np.arange(19) - 1, 0)]
    np.testing.assert_array_equal(got, want)


def test_custom_energy_variance_matches_numpy():
    luma = _rand_luma(24, 40, seed=3)
    radius = 2
    n = 2 * radius
    fn = custom_energy(radius, lambda w: jnp.var(w), name="variance")
    got = np.asarray(jax.jit(fn.energy_map)(jnp.asarray(luma)))

    H, W = luma.shape
    co = -(radius - 1)
    want = np.empty((H, W), np.float32)
    for i in range(H):
        for j in range(W):
            ys = np.clip(np.arange(i + co, i + co + n), 0, H - 1)
            xs = np.clip(np.arange(j + co, j + co + n), 0, W - 1)
            want[i, j] = np.var(luma[np.ix_(ys, xs)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("energy", ["grad_norm", "grad_sumabs"])
def test_strip_equals_full_for_plugged_energy(energy):
    fn = builtin_energy(energy)
    luma = jnp.asarray(_rand_luma(48, 80, seed=4))
    full = carve_n_seams(luma, 10, 8, 0.0, 1.0, strip_update=False,
                         energy_fn=fn)
    strip = carve_n_seams(luma, 10, 8, 0.0, 1.0, strip_update=True,
                          energy_fn=fn)
    np.testing.assert_array_equal(np.asarray(full.vmap), np.asarray(strip.vmap))
    # live-region energies bitwise equal (dead region is unspecified)
    w = int(full.width)
    np.testing.assert_array_equal(
        np.asarray(full.energy)[:, :w], np.asarray(strip.energy)[:, :w]
    )


def test_strip_equals_full_for_custom_energy():
    fn = custom_energy(2, lambda w: jnp.sum(jnp.abs(w)) - 16.0 * jnp.abs(w[1, 1]),
                       name="absdev")
    luma = jnp.asarray(_rand_luma(40, 64, seed=5))
    full = carve_n_seams(luma, 8, 8, 0.0, 1.0, strip_update=False, energy_fn=fn)
    strip = carve_n_seams(luma, 8, 8, 0.0, 1.0, strip_update=True, energy_fn=fn)
    np.testing.assert_array_equal(np.asarray(full.vmap), np.asarray(strip.vmap))


def test_carve_with_grad_sumabs_matches_oracle_dp():
    """End-to-end: seam selection with the plugged gradient energy equals a
    scalar NumPy carve driving the oracle DP with the same energy (grad_sumabs
    is bitwise across backends, so parity is exact)."""
    luma = _rand_luma(32, 48, seed=6)
    n_seams = 6

    cur = luma.copy()
    H, W = cur.shape
    origcol = np.broadcast_to(np.arange(W, dtype=np.int32), (H, W)).copy()
    vmap_ref = np.zeros((H, W), np.int32)
    for k in range(1, n_seams + 1):
        E = oracle.gradient_energy_map(cur, "grad_sumabs")
        seam = oracle.find_seam(E)
        vmap_ref[np.arange(H), origcol[np.arange(H), seam]] = k
        cur = oracle._remove_seam(cur, seam)
        origcol = oracle._remove_seam(origcol, seam)

    state = carve_n_seams(jnp.asarray(luma), n_seams, 8, 0.0, 1.0,
                          energy_fn=GRAD_SUMABS)
    np.testing.assert_array_equal(np.asarray(state.vmap), vmap_ref)


def test_full_energy_map_dispatches_energy_fn():
    luma = jnp.asarray(_rand_luma(16, 24, seed=7))
    got = np.asarray(jax.jit(
        full_energy_map, static_argnames=("blocksize", "energy_fn")
    )(luma, 8, 0.0, 1.0, energy_fn=GRAD_XABS))
    want = oracle.gradient_energy_map(np.asarray(luma), "grad_xabs")
    np.testing.assert_array_equal(got, want)


def test_resolve_energy_and_validation():
    assert resolve_energy(None) is None
    assert resolve_energy("dct") is None
    assert resolve_energy("grad_norm") is GRAD_NORM
    assert resolve_energy(GRAD_XABS) is GRAD_XABS
    with pytest.raises(ValueError):
        resolve_energy("nope")
    with pytest.raises(TypeError):
        resolve_energy(42)
    with pytest.raises(ValueError):
        custom_energy(0, lambda w: w[0, 0])
    with pytest.raises(ValueError):
        resolve_energy(EnergyFunction("odd", 3, lambda b: b[:, 0, :-2]))


def test_api_and_config_energy_knob():
    from dct_carver_tpu.api import carve
    from dct_carver_tpu.utils.config import CarverConfig

    img = np.random.default_rng(8).integers(0, 256, (24, 36, 3), np.uint8)
    res = carve(img, -5, energy="grad_norm", output_seams=True)
    assert res.image.shape == (24, 31, 3)
    assert (res.visibility_map > 0).sum(axis=1).tolist() == [5] * 24

    cfg = CarverConfig(energy="grad_sumabs")
    assert cfg.energy_function is builtin_energy("grad_sumabs")
    assert cfg.radius == 1
    with pytest.raises(ValueError):
        CarverConfig(energy="bogus")


def test_checkpoint_roundtrip_with_builtin_energy(tmp_path):
    from dct_carver_tpu.utils.checkpoint import carve_resumable, save_state
    from dct_carver_tpu.utils.config import CarverConfig
    from dct_carver_tpu.ops.carve import make_state

    luma = _rand_luma(24, 40, seed=9)
    cfg = CarverConfig(energy="grad_norm")
    ck = str(tmp_path / "state.npz")
    st_full = carve_resumable(luma, 6, cfg)
    carve_resumable(luma, 6, cfg, checkpoint_path=ck, checkpoint_every=3)
    st_resumed = carve_resumable(None, 6, cfg, resume_from=ck)
    np.testing.assert_array_equal(np.asarray(st_full.vmap),
                                  np.asarray(st_resumed.vmap))

    cfg_custom = CarverConfig(energy=custom_energy(1, lambda w: w[0, 0]))
    with pytest.raises(ValueError, match="checkpoint"):
        save_state(str(tmp_path / "bad.npz"),
                   make_state(jnp.asarray(luma)), cfg_custom, 0, 1)


def test_batch_carve_with_energy():
    from dct_carver_tpu.parallel.mesh import carve_batch

    imgs = np.random.default_rng(10).integers(0, 256, (4, 24, 32, 3), np.uint8)
    out, vmaps = carve_batch(imgs, 4, energy="grad_xabs")
    assert out.shape == (4, 24, 28, 3)
    assert ((np.asarray(vmaps) > 0).sum(axis=2) == 4).all()
