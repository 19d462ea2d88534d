"""Randomized-configuration parity sweep vs the NumPy oracle.

The targeted tests pin specific shapes/knobs; this module walks a seeded
random grid over (shape, blocksize, weights, seams, image kind,
delta_x/rigidity, strip on/off, DP kernel (interpreter) on/off) and asserts full-carve
visibility-map parity with `oracle.carve_seams` every time.  Seeded, so
failures reproduce; small shapes keep the sweep under a minute.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from dct_carver_tpu.oracle import reference as oracle
from dct_carver_tpu.ops.carve import carve_n_seams


def _image(rng, h, w, kind):
    if kind == "noise":
        return rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    if kind == "smooth":
        y = np.linspace(0, 255, h)[:, None]
        x = np.linspace(0, 255, w)[None, :]
        img = ((y + x) / 2).astype(np.uint8)
        return np.repeat(img[..., None], 3, axis=-1)
    if kind == "quantized":  # exact-tie breeding ground
        return (rng.integers(0, 4, size=(h, w, 3)) * 80).astype(np.uint8)
    if kind == "structured":
        img = rng.integers(0, 60, size=(h, w, 3), dtype=np.uint8)
        img[h // 3 : h // 3 + 2, :] = 250
        img[:, w // 2] = 240
        return img
    raise ValueError(kind)


@pytest.mark.parametrize("trial", range(12))
def test_random_config_carve_parity(trial):
    rng = np.random.default_rng(1000 + trial)
    h = int(rng.integers(12, 40))
    w = int(rng.integers(24, 72))
    blocksize = int(rng.choice([2, 4, 8, 16]))
    slider = float(rng.choice([0.0, 0.25, 0.5, 1.0]))
    edges, textures = 1.0 - slider, slider
    n = int(rng.integers(1, min(8, w - 2)))
    kind = ["noise", "smooth", "quantized", "structured"][trial % 4]
    strip = bool(trial % 2)
    kernel = trial % 3 == 0  # the seam-DP kernel through the interpreter

    img = _image(rng, h, w, kind)
    luma = np.asarray(oracle.luma_bt709(img), np.float32)

    _, ref_vmap, _ = oracle.carve_seams(img, n, blocksize, edges, textures)
    got = carve_n_seams(jnp.asarray(luma), n, blocksize, edges, textures,
                        strip_update=strip, interpret=kernel)
    np.testing.assert_array_equal(
        np.asarray(got.vmap), ref_vmap,
        err_msg=f"trial={trial} h={h} w={w} n={n} bs={blocksize} "
                f"s={slider} kind={kind} strip={strip} kernel={kernel}",
    )


@pytest.mark.parametrize("trial", range(6))
def test_random_config_generalized_dp_parity(trial):
    """delta_x/rigidity sweep vs the oracle's generalized recurrence."""
    rng = np.random.default_rng(2000 + trial)
    h = int(rng.integers(12, 32))
    w = int(rng.integers(24, 56))
    dx = int(rng.integers(1, 4))
    rig = float(rng.choice([0.0, 0.3, 1.0, 2.5]))
    n = int(rng.integers(1, 5))
    img = _image(rng, h, w, ["noise", "quantized", "structured"][trial % 3])
    luma = np.asarray(oracle.luma_bt709(img), np.float32)

    _, ref_vmap, _ = oracle.carve_seams(img, n, 8, 0.2, 0.8,
                                        delta_x=dx, rigidity=rig)
    got = carve_n_seams(jnp.asarray(luma), n, 8, 0.2, 0.8,
                        delta_x=dx, rigidity=rig)
    np.testing.assert_array_equal(
        np.asarray(got.vmap), ref_vmap,
        err_msg=f"trial={trial} h={h} w={w} n={n} dx={dx} rig={rig}",
    )


def _tie_corpus(rng, h, w, kind):
    """Images that FORCE exact DP ties (docs/PARITY.md S1/S2)."""
    if kind == "constant":       # zero energy everywhere -> all-ties DP
        return np.full((h, w, 3), 137, np.uint8)
    if kind == "stripes":        # periodic columns -> exact-equal energies
        col = (np.arange(w) % 2) * 120 + 60
        return np.repeat(np.broadcast_to(col, (h, w)).astype(np.uint8)[..., None],
                         3, axis=-1)
    if kind == "two_blobs":      # two mirror-identical cheap corridors
        img = np.full((h, w, 3), 200, np.uint8)
        img[:, w // 4] = 0
        img[:, 3 * w // 4] = 0
        return img
    raise ValueError(kind)


@pytest.mark.parametrize("tie", ["leftmost", "rightmost"])
@pytest.mark.parametrize("kind", ["constant", "stripes", "two_blobs"])
def test_forced_tie_all_paths_agree(tie, kind):
    """Under forced exact ties, every path — oracle, scan, the seam-DP
    kernel (interpreter), native C++ f32-chain — must pick the SAME seams at BOTH tie
    settings: the S1/S2 spec choice is a covered parameter, not a fixed
    guess."""
    from dct_carver_tpu.utils.native import native_available, carve_native_f32

    rng = np.random.default_rng(7)
    h, w, n = 16, 48, 4
    img = _tie_corpus(rng, h, w, kind)
    luma = np.asarray(oracle.luma_bt709(img), np.float32)

    _, ref_vmap, _ = oracle.carve_seams(img, n, 8, 0.3, 0.7, tie=tie)
    scan = carve_n_seams(jnp.asarray(luma), n, 8, 0.3, 0.7, tie=tie)
    np.testing.assert_array_equal(np.asarray(scan.vmap), ref_vmap,
                                  err_msg=f"scan {tie} {kind}")
    kern = carve_n_seams(jnp.asarray(luma), n, 8, 0.3, 0.7,
                         interpret=True, tie=tie)
    np.testing.assert_array_equal(np.asarray(kern.vmap), ref_vmap,
                                  err_msg=f"kernel {tie} {kind}")
    if native_available():
        nat = carve_native_f32(luma, n, 8, 0.3, 0.7, tie=tie)
        np.testing.assert_array_equal(nat, ref_vmap,
                                      err_msg=f"native {tie} {kind}")


@pytest.mark.parametrize("tie", ["leftmost", "rightmost"])
def test_forced_tie_spatial_agrees(tie):
    """The mesh-sharded path must apply the tie knob identically (incl. the
    cross-shard global argmin and the segment walks)."""
    import jax

    from dct_carver_tpu.parallel.mesh import make_mesh
    from dct_carver_tpu.parallel.spatial import spatial_carve_n_seams

    assert len(jax.devices()) == 8
    mesh = make_mesh(axis_name="x")
    rng = np.random.default_rng(11)
    for kind in ("constant", "two_blobs"):
        img = _tie_corpus(rng, 16, 64, kind)
        luma = np.asarray(oracle.luma_bt709(img), np.float32)
        n = 3
        single = carve_n_seams(jnp.asarray(luma), n, 8, 0.3, 0.7, tie=tie)
        sharded = spatial_carve_n_seams(luma, n, mesh=mesh, edges=0.3,
                                        textures=0.7, tie=tie)
        np.testing.assert_array_equal(
            np.asarray(sharded.vmap), np.asarray(single.vmap),
            err_msg=f"spatial {tie} {kind}")


def test_tie_knob_changes_tied_seams():
    """Sanity: on an all-ties image the two conventions pick different
    seams (leftmost hugs column 0, rightmost the last live column) — the
    knob is live, not decorative."""
    img = _tie_corpus(None, 12, 32, "constant")
    luma = np.asarray(oracle.luma_bt709(img), np.float32)
    left = carve_n_seams(jnp.asarray(luma), 1, 8, 0.0, 1.0, tie="leftmost")
    right = carve_n_seams(jnp.asarray(luma), 1, 8, 0.0, 1.0, tie="rightmost")
    lcols = np.argwhere(np.asarray(left.vmap) == 1)[:, 1]
    rcols = np.argwhere(np.asarray(right.vmap) == 1)[:, 1]
    assert (lcols == 0).all(), lcols
    assert (rcols == 31).all(), rcols


@pytest.mark.parametrize("trial", range(4))
def test_random_enlargement_parity(trial):
    """Random enlargement configs.

    Insertion VALUE semantics (rounded-mean duplicates after every seam
    pixel, border-clamped — liblqr, src/render.c:344-364) are checked
    against a direct scalar replay of the API's own visibility map for
    every image kind; full-pipeline parity vs the f64 oracle only on noise
    images (tie-heavy smooth gradients legitimately diverge between the
    f32 production path and the f64 oracle — the two documented precision
    levels, docs/PARITY.md)."""
    rng = np.random.default_rng(3000 + trial)
    h = int(rng.integers(12, 28))
    w = int(rng.integers(24, 48))
    n = int(rng.integers(1, 6))
    kind = ["noise", "smooth"][trial % 2]
    img = _image(rng, h, w, kind)

    from dct_carver_tpu.api import carve as api_carve

    res = api_carve(img, n, blocksize=8, edges=0.3, textures=0.7,
                    output_seams=True)
    vmap = np.asarray(res.visibility_map)

    # scalar replay of the insertion on the API's own seams
    ref = np.empty((h, w + n, 3), img.dtype)
    for i in range(h):
        pos = 0
        for j in range(w):
            ref[i, pos] = img[i, j]
            pos += 1
            if vmap[i, j] > 0:
                nbr = img[i, min(j + 1, w - 1)]
                val = np.floor(
                    (img[i, j].astype(np.float64) + nbr) / 2.0 + 0.5)
                ref[i, pos] = val.astype(img.dtype)
                pos += 1
    np.testing.assert_array_equal(np.asarray(res.image), ref,
                                  err_msg=f"trial={trial} h={h} w={w} n={n}")

    if kind == "noise":
        ref_out, ref_vmap = oracle.carve(img, n, 8, 0.3, 0.7)
        np.testing.assert_array_equal(vmap, ref_vmap)
        np.testing.assert_array_equal(np.asarray(res.image), ref_out)
