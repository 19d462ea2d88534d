"""The XLA form of each carve stage against an independent reference.

Energy against the native f32-chain carver (bitwise) and the NumPy oracle;
seam compaction against a per-row NumPy deletion; strip updates against a
full recompute; batched (vmap) forms against a per-image loop.

Bitwise energy comparisons run op by op (no jit): XLA:CPU contracts the
multiply-add chains into FMAs inside fused code, which moves the last bit.
On the H100 the fused chains are bitwise equal to the native carver
(docs/PARITY.md), which tests/test_chip.py checks on the card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dct_carver_tpu.oracle import reference as oracle
from dct_carver_tpu.ops import dp
from dct_carver_tpu.ops.carve import (_edge_fill, _recompute_strip,
                                      carve_n_seams, full_energy_map,
                                      make_state, strip_row_block)
from dct_carver_tpu.ops.dct import dct_energy_map
from dct_carver_tpu.utils.native import energy_map_native_f32, native_available

needs_native = pytest.mark.skipif(not native_available(),
                                  reason="native library failed to build")


def _photo(h, w, seed=5):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = xx * 1.7 + 25 * np.sin(yy / 7.0) + 20 * np.cos(xx / 11.0)
    img = img + rng.normal(0, 5, size=(h, w))
    return ((img % 256) / 255.0).astype(np.float32)


# ------------------------------------------------------------------ energy --

@needs_native
@pytest.mark.parametrize("blocksize", [2, 4, 8, 16])
def test_energy_xla_bitwise_native(blocksize):
    luma = _photo(70, 150)
    got = np.asarray(full_energy_map(jnp.asarray(luma), blocksize, 0.3, 0.9))
    ref = energy_map_native_f32(luma, blocksize, 0.3, 0.9)
    np.testing.assert_array_equal(got, ref)


@needs_native
def test_energy_xla_wide_bitwise_native():
    luma = _photo(66, 700, seed=9)
    got = np.asarray(full_energy_map(jnp.asarray(luma), 8, 0.0, 1.0))
    np.testing.assert_array_equal(got, energy_map_native_f32(luma, 8, 0.0,
                                                             1.0))


def test_energy_preview_center_matches_oracle():
    """The GUI preview centring (src/dct.h:8-9) at f64 against the oracle."""
    luma = _photo(40, 90, seed=3).astype(np.float64)
    ref = oracle.energy_map(luma, 8, 0.5, 0.5, center="preview")
    with jax.enable_x64(True):
        got = dct_energy_map(jnp.asarray(luma), 8, 0.5, 0.5,
                             center="preview")
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=3e-7,
                               atol=1e-12)
    carve = oracle.energy_map(luma, 8, 0.5, 0.5)
    assert not np.array_equal(ref, carve)  # the centring is live


# ----------------------------------------------------------------- apply --

def _np_apply(luma, origcol, energy, seam, width):
    """Per-row deletion, then the dead region edge-filled from the new last
    live column."""
    H, W = luma.shape
    out = []
    for a in (luma, origcol, energy):
        rows = [np.concatenate([np.delete(r[:width], s), r[width:], r[-1:]])
                for r, s in zip(a, seam)]
        out.append(np.stack(rows)[:, :W])
    l2 = out[0].copy()
    l2[:, width - 1:] = l2[:, width - 2: width - 1]
    return l2, out[1], out[2]


@pytest.mark.parametrize("mode", ["interior", "left", "right-edge", "shrunk"])
def test_apply_matches_row_deletion(mode):
    rng = np.random.default_rng(3)
    H, W = 16, 256
    luma = rng.random((H, W), dtype=np.float32)
    origcol = rng.integers(0, 4 * W, (H, W)).astype(np.int32)
    energy = rng.random((H, W), dtype=np.float32)
    width = W - 5 if mode == "shrunk" else W
    if mode == "interior":
        seam = (np.cumsum(rng.integers(-1, 2, H)) + 100) % (width - 2) + 1
    elif mode == "left":
        seam = np.minimum(np.arange(H), 2)
    elif mode == "right-edge":
        seam = np.full(H, width - 1)  # removes the logical edge column
    else:
        seam = np.full(H, width - 3)
    seam = seam.astype(np.int32)

    s = jnp.asarray(seam)
    l2 = _edge_fill(dp.remove_seam(jnp.asarray(luma), s), jnp.int32(width - 1))
    oc2 = dp.remove_seam(jnp.asarray(origcol), s)
    e2 = dp.remove_seam(jnp.asarray(energy), s)
    rl, roc, re = _np_apply(luma, origcol, energy, seam, width)
    live = width - 1
    np.testing.assert_array_equal(np.asarray(l2)[:, :width], rl[:, :width])
    np.testing.assert_array_equal(np.asarray(oc2)[:, :live], roc[:, :live])
    np.testing.assert_array_equal(np.asarray(e2)[:, :live], re[:, :live])


# ----------------------------------------------------------------- strip --

@pytest.mark.parametrize("hw,blocksize", [((16, 256), 4), ((24, 384), 8),
                                          ((48, 384), 8), ((40, 512), 16)])
def test_strip_update_equals_full_recompute(hw, blocksize, rng):
    """One strip update per seam writes bitwise the energy a full recompute
    gives, at every live column, seam after seam (op by op, see above)."""
    H, W = hw
    luma = jnp.asarray(rng.random((H, W)).astype(np.float32))
    st = make_state(luma)
    st = st._replace(energy=full_energy_map(luma, blocksize, 0.3, 0.8))

    def step(st, seam):
        return _recompute_strip(st, seam, blocksize, 0.3, 0.8)

    for _ in range(3):
        seam = dp.find_seam(dp.mask_energy(st.energy, st.width))
        width = st.width - 1
        luma2 = _edge_fill(dp.remove_seam(st.luma, seam), width)
        mid = st._replace(luma=luma2, width=width)
        e_strip = step(mid, seam)
        e_full = full_energy_map(luma2, blocksize, 0.3, 0.8)
        live = int(width)
        np.testing.assert_array_equal(np.asarray(e_strip)[:, :live],
                                      np.asarray(e_full)[:, :live])
        st = mid._replace(energy=e_strip)


@pytest.mark.parametrize("H,n,W,R", [(1080, 8, 1920, 72), (2160, 16, 3840, 72),
                                     (1024, 8, 1024, 64), (37, 8, 256, 8)])
def test_strip_row_block_choice(H, n, W, R):
    """R divides H and keeps the tap window within 128 columns; seams do not
    depend on it (asserted by the carve tests)."""
    assert strip_row_block(H, n, 1, W) == R


# ------------------------------------------------------------------ vmap --

def test_vmap_apply_matches_per_image(rng):
    B, H, W = 3, 16, 64
    luma = jnp.asarray(rng.random((B, H, W)).astype(np.float32))
    widths = jnp.asarray([W, 50, 33], jnp.int32)
    seams = jnp.asarray(rng.integers(0, 30, (B, H)), jnp.int32)

    def apply(l, s, w):
        return _edge_fill(dp.remove_seam(l, s), w - 1)

    got = jax.jit(jax.vmap(apply))(luma, seams, widths)
    for i in range(B):
        np.testing.assert_array_equal(
            np.asarray(got[i]), np.asarray(apply(luma[i], seams[i],
                                                 widths[i])))


def test_vmap_strip_update_matches_per_image(rng):
    B, H, W, n = 2, 24, 96, 8
    lumas = jnp.asarray(rng.random((B, H, W)).astype(np.float32))

    def one(l):
        st = make_state(l)
        st = st._replace(energy=full_energy_map(l, n, 0.3, 0.8))
        seam = dp.find_seam(st.energy)
        mid = st._replace(luma=_edge_fill(dp.remove_seam(l, seam),
                                          st.width - 1), width=st.width - 1)
        return _recompute_strip(mid, seam, n, 0.3, 0.8)

    got = jax.jit(jax.vmap(one))(lumas)
    for i in range(B):
        np.testing.assert_array_equal(np.asarray(got[i]),
                                      np.asarray(jax.jit(one)(lumas[i])))


@pytest.mark.parametrize("strip", [True, False])
def test_vmap_full_carve_matches_per_image(strip, rng):
    """The batch route (vmap of the whole carve) carves each image exactly
    as a per-image call does."""
    from dct_carver_tpu.parallel.mesh import batch_carve_states

    B, H, W, n = 3, 16, 64, 4
    imgs = jnp.asarray(rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8))
    states = batch_carve_states(imgs, n, 8, 0.3, 0.8, strip)
    from dct_carver_tpu.ops.energy import to_luma

    for i in range(B):
        ref = carve_n_seams(to_luma(imgs[i]), n, 8, 0.3, 0.8,
                            strip_update=strip)
        np.testing.assert_array_equal(np.asarray(states.vmap[i]),
                                      np.asarray(ref.vmap))
        assert int(states.width[i]) == W - n
