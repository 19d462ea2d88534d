"""Spatially-sharded carving must match the single-device path seam-for-seam."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dct_carver_tpu.ops import carve as carve_ops
from dct_carver_tpu.parallel.mesh import make_mesh
from dct_carver_tpu.parallel.spatial import spatial_carve_n_seams
from dct_carver_tpu.oracle import reference as oracle


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8
    return make_mesh(axis_name="x")


def _luma(h, w, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    return np.asarray(oracle.luma_bt709(img), np.float32), img


@pytest.mark.parametrize("blocksize", [4, 8, 16])
def test_spatial_matches_single_device(mesh8, blocksize):
    luma_np, _ = _luma(32, 64)
    n = 5
    single = carve_ops.carve_n_seams(
        jnp.asarray(luma_np), n, blocksize, 0.3, 0.8, strip_update=False
    )
    sharded = spatial_carve_n_seams(
        luma_np, n, blocksize=blocksize, edges=0.3, textures=0.8, mesh=mesh8
    )
    np.testing.assert_array_equal(
        np.asarray(sharded.vmap), np.asarray(single.vmap)
    )
    assert int(sharded.width) == 64 - n


def test_spatial_seam_crossing_boundaries(mesh8):
    """A low-energy path crossing shard boundaries must be found globally."""
    h, w = 24, 64
    rng = np.random.default_rng(1)
    luma = rng.random((h, w), dtype=np.float32) * 0.5 + 0.4
    # carve a cheap diagonal corridor from col 5 to col 55 (crosses 7 shards)
    for i in range(h):
        j = 5 + int(round(i * 50 / (h - 1)))
        luma[i, j] = 0.0
        luma[i, min(j + 1, w - 1)] = 0.01
    single = carve_ops.carve_n_seams(
        jnp.asarray(luma), 2, 8, 0.0, 1.0, strip_update=False
    )
    sharded = spatial_carve_n_seams(luma, 2, mesh=mesh8)
    np.testing.assert_array_equal(
        np.asarray(sharded.vmap), np.asarray(single.vmap)
    )
    # sanity: the seam actually spans many shards
    cols = np.argwhere(np.asarray(single.vmap) == 1)[:, 1]
    assert cols.min() // 8 != cols.max() // 8


@pytest.mark.parametrize("w", [60, 61])
def test_spatial_width_not_divisible(mesh8, w):
    """Non-divisible widths are edge-padded internally; seams must still be
    bitwise-identical to the single-device path and results reported at the
    original width."""
    luma_np, img = _luma(16, w)
    n = 3
    single = carve_ops.carve_n_seams(
        jnp.asarray(luma_np), n, 8, 0.0, 1.0, strip_update=False
    )
    sharded = spatial_carve_n_seams(luma_np, n, mesh=mesh8, image=img)
    assert sharded.vmap.shape == (16, w)
    np.testing.assert_array_equal(
        np.asarray(sharded.vmap), np.asarray(single.vmap)
    )
    ref = carve_ops.reconstruct_removed(jnp.asarray(img), single.vmap, n)
    np.testing.assert_array_equal(
        np.asarray(sharded.image)[:, : w - n], np.asarray(ref))
    assert int(sharded.width) == w - n


@pytest.mark.parametrize("dx_rig", [(2, 0.0), (1, 0.5), (3, 1.5)])
def test_spatial_delta_x_rigidity(mesh8, dx_rig):
    """The generalized DP (delta_x steps/row + rigidity penalty — the
    lqr_carver_init parameters) must match the single-device generalized
    path seam-for-seam."""
    dx, rig = dx_rig
    luma_np, _ = _luma(24, 64, seed=19)
    n = 4
    single = carve_ops.carve_n_seams(
        jnp.asarray(luma_np), n, 8, 0.2, 0.9, strip_update=False,
        delta_x=dx, rigidity=rig,
    )
    sharded = spatial_carve_n_seams(
        luma_np, n, mesh=mesh8, edges=0.2, textures=0.9,
        delta_x=dx, rigidity=rig, strip_update=False,
    )
    np.testing.assert_array_equal(
        np.asarray(sharded.vmap), np.asarray(single.vmap)
    )


def test_spatial_delta_x_strip_update(mesh8):
    """delta_x widens the strip; the sharded strip update must stay exact."""
    luma_np, _ = _luma(24, 128, seed=23)
    n = 4
    single = carve_ops.carve_n_seams(
        jnp.asarray(luma_np), n, 8, 0.0, 1.0, strip_update=True, delta_x=2,
    )
    sharded = spatial_carve_n_seams(
        luma_np, n, mesh=mesh8, delta_x=2, strip_update=True,
    )
    np.testing.assert_array_equal(
        np.asarray(sharded.vmap), np.asarray(single.vmap)
    )


@pytest.mark.parametrize("K", [4, 7, 64])
def test_spatial_frontier_block_sizes(mesh8, K):
    """Blocked DP/backtrack must be exact for any K (incl. K > H and
    remainder blocks H % K != 0)."""
    luma_np, _ = _luma(24, 64, seed=3)
    n = 4
    single = carve_ops.carve_n_seams(
        jnp.asarray(luma_np), n, 8, 0.0, 1.0, strip_update=False
    )
    sharded = spatial_carve_n_seams(
        luma_np, n, mesh=mesh8, frontier_block=K
    )
    np.testing.assert_array_equal(
        np.asarray(sharded.vmap), np.asarray(single.vmap)
    )


def test_spatial_strip_vs_full_recompute(mesh8):
    """The sharded per-seam strip update must give the same seams as the
    sharded full recompute (and both match single-device)."""
    luma_np, _ = _luma(32, 128, seed=5)
    n = 6
    a = spatial_carve_n_seams(luma_np, n, mesh=mesh8, strip_update=True)
    b = spatial_carve_n_seams(luma_np, n, mesh=mesh8, strip_update=False)
    np.testing.assert_array_equal(np.asarray(a.vmap), np.asarray(b.vmap))
    single = carve_ops.carve_n_seams(
        jnp.asarray(luma_np), n, 8, 0.0, 1.0, strip_update=True
    )
    np.testing.assert_array_equal(np.asarray(a.vmap), np.asarray(single.vmap))


def test_spatial_image_carry_reconstructs(mesh8):
    """Carrying the RGB image through the sharded compaction must equal
    reconstruct_removed on the single-device vmap."""
    luma_np, img = _luma(16, 64, seed=7)
    n = 3
    res = spatial_carve_n_seams(luma_np, n, mesh=mesh8, image=img)
    ref_state = carve_ops.carve_n_seams(
        jnp.asarray(luma_np), n, 8, 0.0, 1.0, strip_update=False
    )
    ref = carve_ops.reconstruct_removed(
        jnp.asarray(img), ref_state.vmap, n)
    got = np.asarray(res.image)[:, : 64 - n]
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_spatial_chunked_checkpoint_resume(mesh8, tmp_path):
    """Chunked spatial carve with an orbax sharded checkpoint must resume to
    the exact same visibility map."""
    luma_np, img = _luma(16, 64, seed=11)
    n = 5
    ref = spatial_carve_n_seams(luma_np, n, mesh=mesh8, image=img)

    ck = str(tmp_path / "spatial_ck")
    # run only the first chunk (2 seams), checkpointing
    got = spatial_carve_n_seams(luma_np, n, mesh=mesh8, image=img,
                                chunk=2, checkpoint_dir=ck)
    np.testing.assert_array_equal(np.asarray(got.vmap), np.asarray(ref.vmap))

    # resume from the 2-seam checkpoint and finish
    res = spatial_carve_n_seams(luma_np, n, mesh=mesh8, image=img,
                                resume_from=ck)
    np.testing.assert_array_equal(np.asarray(res.vmap), np.asarray(ref.vmap))
    np.testing.assert_array_equal(np.asarray(res.image), np.asarray(ref.image))
    assert int(res.width) == 64 - n


def test_spatial_resume_param_mismatch_raises(mesh8, tmp_path):
    """Resuming with different carve parameters must be rejected — a silent
    mixed-parameter carve is worse than an error."""
    luma_np, _ = _luma(16, 64, seed=13)
    ck = str(tmp_path / "ck")
    spatial_carve_n_seams(luma_np, 4, mesh=mesh8, chunk=2,
                          checkpoint_dir=ck, edges=0.3, textures=0.7)
    with pytest.raises(ValueError, match="parameter"):
        spatial_carve_n_seams(luma_np, 4, mesh=mesh8, resume_from=ck,
                              edges=0.9, textures=0.1)


def test_spatial_resume_with_image_mismatch_raises(mesh8, tmp_path):
    """Resuming with image=... a checkpoint saved without one (or vice
    versa) must be rejected — the carve would otherwise silently run on the
    (1, nsh) placeholder and return garbage."""
    luma_np, img = _luma(16, 64, seed=41)
    ck = str(tmp_path / "ck_noimg")
    spatial_carve_n_seams(luma_np, 4, mesh=mesh8, chunk=2, checkpoint_dir=ck)
    with pytest.raises(ValueError, match="with_image"):
        spatial_carve_n_seams(luma_np, 4, mesh=mesh8, resume_from=ck,
                              image=img)
    ck2 = str(tmp_path / "ck_img")
    spatial_carve_n_seams(luma_np, 4, mesh=mesh8, chunk=2,
                          checkpoint_dir=ck2, image=img)
    with pytest.raises(ValueError, match="with_image"):
        spatial_carve_n_seams(luma_np, 4, mesh=mesh8, resume_from=ck2)


@pytest.mark.parametrize("energy", ["grad_norm", "grad_sumabs"])
def test_spatial_energy_fn_matches_single_device(mesh8, energy):
    """Pluggable energies (the lqr_carver_set_energy_function analog) must be
    honored on the sharded path: seam-for-seam identical to the
    single-device gradient carve, with strip updates on."""
    from dct_carver_tpu.ops.energy_fn import builtin_energy

    luma_np, _ = _luma(24, 64, seed=37)
    n = 4
    single = carve_ops.carve_n_seams(
        jnp.asarray(luma_np), n, 8, 0.0, 1.0, strip_update=True,
        energy_fn=builtin_energy(energy),
    )
    sharded = spatial_carve_n_seams(
        luma_np, n, mesh=mesh8, energy=energy, strip_update=True,
    )
    np.testing.assert_array_equal(
        np.asarray(sharded.vmap), np.asarray(single.vmap)
    )


def test_spatial_custom_energy_matches_single_device(mesh8):
    """A user-written per-window energy function (custom_energy — the
    closest analog of the reference's per-pixel callback) must carve
    identically sharded and unsharded."""
    from dct_carver_tpu.ops.energy_fn import custom_energy

    fn = custom_energy(
        2, lambda w: jnp.abs(w[2, 2] - w.mean()), name="dev_from_mean")
    luma_np, _ = _luma(16, 64, seed=39)
    n = 3
    single = carve_ops.carve_n_seams(
        jnp.asarray(luma_np), n, 8, 0.0, 1.0, strip_update=False,
        energy_fn=fn,
    )
    sharded = spatial_carve_n_seams(
        luma_np, n, mesh=mesh8, energy=fn, strip_update=False,
    )
    np.testing.assert_array_equal(
        np.asarray(sharded.vmap), np.asarray(single.vmap)
    )


def test_spatial_progress_hook(mesh8):
    """The liblqr progress-hook analog on the spatial path: init, one update
    per chunk (monotonic, ending at 1.0), end."""
    calls = []

    class Rec:
        def init(self, msg):
            calls.append(("init", msg))

        def update(self, f):
            calls.append(("update", f))

        def end(self):
            calls.append(("end", None))

    luma_np, _ = _luma(16, 64, seed=43)
    spatial_carve_n_seams(luma_np, 5, mesh=mesh8, chunk=2, progress=Rec())
    assert calls[0][0] == "init" and calls[-1] == ("end", None)
    fracs = [f for k, f in calls if k == "update"]
    assert fracs == sorted(fracs) and fracs[-1] == 1.0 and len(fracs) == 3


def test_sharded_checkpoint_atomic_progress(mesh8, tmp_path):
    """The progress counter is the committed step directory name, never the
    side-car meta.json — a preemption between the state write and the meta
    write cannot pair stale progress with new state."""
    import json
    import os

    from dct_carver_tpu.parallel.spatial import spatial_make_state
    from dct_carver_tpu.utils.checkpoint import load_sharded, save_sharded
    from dct_carver_tpu.parallel.spatial import SpatialCarveState

    luma_np, _ = _luma(16, 64, seed=17)
    state, mesh = spatial_make_state(luma_np, mesh=mesh8)
    ck = str(tmp_path / "ck")
    save_sharded(ck, state, {"seams_done": 2, "n_seams_total": 6})
    save_sharded(ck, state, {"seams_done": 4, "n_seams_total": 6})

    # simulate a preemption that left meta.json stale (older seams_done)
    with open(os.path.join(ck, "meta.json")) as f:
        meta = json.load(f)
    meta["seams_done"] = 2
    with open(os.path.join(ck, "meta.json"), "w") as f:
        json.dump(meta, f)

    restored, meta2 = load_sharded(ck, mesh, "x", SpatialCarveState)
    assert meta2["seams_done"] == 4  # from the committed step, not the file
    # old steps are pruned; exactly one committed step remains
    steps = [n for n in os.listdir(ck) if n.startswith("state-")]
    assert steps == ["state-00000004"]
    # restored leaves carry the same shardings as the live state
    assert restored.luma.sharding == state.luma.sharding
    np.testing.assert_array_equal(np.asarray(restored.luma),
                                  np.asarray(state.luma))


@pytest.mark.parametrize("hwk", [(32, 512, 8), (48, 1024, 16),
                                 (32, 2048, 8)])
def test_measured_collectives_match_design(mesh8, hwk):
    """The collective count in the COMPILED HLO of one seam step must match
    the designed budget — catches any collectives a shard_map lowering or
    the partitioner quietly inserts (or merges)."""
    from dct_carver_tpu.parallel.spatial import measure_collectives_per_seam

    H, W, K = hwk
    m = measure_collectives_per_seam(H, W, mesh8, frontier_block=K)
    assert m["total"] == m["designed"], m
    # the design uses only ppermute + psum/pmin: no all-gathers or
    # all-to-alls may appear
    assert set(m["by_op"]) <= {"collective-permute", "all-reduce"}, m


@pytest.mark.parametrize("wk", [(64, 32), (256, 24), (2048, 32)])
def test_spatial_plain_forms_bitwise(mesh8, wk):
    """The per-shard plain forms (block DP scan, segment walk, sharded
    compaction, sharded strip update) must give the seams of the
    single-device strip-updated carve: with 8-column shards under a
    64-column frontier halo (W=64, multi-hop relays), a K=24 block over
    32-column shards (W=256) and 256-column shards (W=2048)."""
    w, K = wk
    luma_np, _ = _luma(48, w, seed=29)
    n = 4
    single = carve_ops.carve_n_seams(jnp.asarray(luma_np), n, 8, 0.0, 1.0,
                                     strip_update=True)
    res = spatial_carve_n_seams(luma_np, n, mesh=mesh8, frontier_block=K)
    np.testing.assert_array_equal(np.asarray(res.vmap),
                                  np.asarray(single.vmap))
    assert int(res.width) == w - n


@pytest.mark.parametrize("w,rgb", [(64, True), (61, False)])
def test_spatial_enlarge_matches_single_device(mesh8, w, rgb):
    """Sharded enlargement (positive seams, liblqr insertion semantics) must
    equal reconstruct_enlarged on the single-device vmap — including the
    rounded-mean duplicates and border clamp, for RGB and gray, and for
    non-divisible widths."""
    from dct_carver_tpu.parallel.spatial import spatial_enlarge_n_seams

    luma_np, img = _luma(16, w, seed=31)
    if not rgb:
        img = img[..., 0]
    n = 5
    single = carve_ops.carve_n_seams(
        jnp.asarray(luma_np), n, 8, 0.0, 1.0, strip_update=False
    )
    ref = carve_ops.reconstruct_enlarged(jnp.asarray(img), single.vmap, n)
    res = spatial_enlarge_n_seams(luma_np, n, img, mesh=mesh8)
    np.testing.assert_array_equal(np.asarray(res.vmap), np.asarray(single.vmap))
    assert res.image.shape[1] == w + n
    np.testing.assert_array_equal(np.asarray(res.image), np.asarray(ref))
    assert int(res.width) == w + n
