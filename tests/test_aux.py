"""Auxiliary subsystems: debug modes, multihost no-op path, batch CLI,
profiling helpers (SURVEY §5 equivalents)."""

import json
import os

import numpy as np
import pytest

import jax.numpy as jnp


def test_debug_mode_nan_detection(rng):
    from dct_carver_tpu.utils.debug import debug_mode

    import jax

    with pytest.raises(FloatingPointError):
        with debug_mode(nan_checks=True):
            x = jnp.zeros(4)
            jax.block_until_ready(x / x)


def test_check_finite(rng):
    from dct_carver_tpu.ops.carve import carve_n_seams
    from dct_carver_tpu.utils.debug import check_finite

    luma = jnp.asarray(rng.random((16, 24), dtype=np.float32))
    state = carve_n_seams(luma, 2, 4, 0.0, 1.0)
    check_finite(state, "after carve")  # must not raise


def test_multihost_single_process_noop():
    from dct_carver_tpu.parallel import multihost

    multihost.initialize()
    assert not multihost.is_distributed()
    multihost.barrier()  # no-op
    h = multihost.process_health()
    assert h["healthy"] and h["processes"] == 1


def test_cli_batch(tmp_path, make_image):
    from dct_carver_tpu.cli import main
    from dct_carver_tpu.utils.image import save_ppm, load_ppm

    ind = tmp_path / "in"
    outd = tmp_path / "out"
    ind.mkdir()
    for i in range(4):
        save_ppm(str(ind / f"img{i}.ppm"), make_image(16, 24, c=3))
    rc = main(["batch", str(ind), str(outd), "--seams", "3", "--blocksize", "4"])
    assert rc == 0
    for i in range(4):
        assert load_ppm(str(outd / f"img{i}.ppm")).shape == (16, 21, 3)


def test_cli_batch_knobs_change_output(tmp_path, make_image):
    """Non-default --energy / --luma must reach the batch path (they were
    silently dropped once — VERDICT r2)."""
    from dct_carver_tpu.cli import main
    from dct_carver_tpu.utils.image import save_ppm, load_ppm

    ind = tmp_path / "in"
    ind.mkdir()
    save_ppm(str(ind / "img.ppm"), make_image(16, 24, c=3))

    outs = {}
    for tag, extra in {
        "default": [],
        "energy": ["--energy", "grad_norm"],
        "luma": ["--luma", "bt601_studio"],
        "rigidity": ["--delta-x", "2", "--rigidity", "5.0"],
    }.items():
        outd = tmp_path / f"out_{tag}"
        rc = main(["batch", str(ind), str(outd), "--seams", "4",
                   "--blocksize", "4"] + extra)
        assert rc == 0
        outs[tag] = load_ppm(str(outd / "img.ppm"))
    for tag in ("energy", "luma", "rigidity"):
        assert outs[tag].shape == outs["default"].shape
        assert (outs[tag] != outs["default"]).any(), tag


def test_cli_batch_size_mismatch(tmp_path, make_image):
    from dct_carver_tpu.cli import main
    from dct_carver_tpu.utils.image import save_ppm

    ind = tmp_path / "in"
    ind.mkdir()
    save_ppm(str(ind / "a.ppm"), make_image(16, 24, c=3))
    save_ppm(str(ind / "b.ppm"), make_image(16, 30, c=3))
    assert main(["batch", str(ind), str(tmp_path / "o"), "--seams", "2"]) == 1


def test_cli_energy_preview(tmp_path, make_image):
    from dct_carver_tpu.cli import main
    from dct_carver_tpu.utils.image import save_ppm, load_ppm

    img = make_image(16, 20, c=3)
    inp = tmp_path / "in.ppm"
    save_ppm(str(inp), img)
    outp = tmp_path / "e.ppm"
    assert main(["energy", str(inp), str(outp), "--preview",
                 "--blocksize", "4"]) == 0
    assert load_ppm(str(outp)).shape == (16, 20)


def test_metrics_json_shape(rng):
    from dct_carver_tpu.utils.progress import Metrics

    m = Metrics(pixels=100, seams=2)
    m.start("x")
    m.stop("x")
    s = m.summary()
    json.dumps(s)  # serializable
    assert "stages_s" in s


def test_profiling_maps_kernels_to_the_seam_dp_scope():
    """The trace reduction attributes a kernel to a name scope through the
    op_name metadata of the compiled HLO; the carve's DP ops carry
    "seam_dp" and the other stages do not."""
    import jax

    from dct_carver_tpu.ops.carve import carve_n_seams
    from dct_carver_tpu.utils.profiling import _kernel_op_names, _key

    hlo = carve_n_seams.lower(jax.ShapeDtypeStruct((16, 64), jnp.float32),
                              2, 8, 0.0, 1.0).compile().as_text()
    names = _kernel_op_names(hlo)
    in_dp = {k for k, v in names.items() if "seam_dp" in v}
    assert in_dp and len(in_dp) < len(names)
    assert all(_key(k) == k for k in names)  # kernel-name normal form
    assert _key("loop_add_fusion.1") == "loop_add_fusion_1"


@pytest.mark.parametrize("spans,busy", [
    ([], 0),
    ([(0, 10)], 10),
    ([(0, 10), (20, 25)], 15),                # a gap is idle
    ([(0, 10), (5, 12)], 12),                 # overlap counted once
    ([(5, 12), (0, 10), (1, 3)], 12),         # unsorted, nested
    ([(0, 10), (10, 20)], 20),                # touching
])
def test_busy_ns_is_the_union_of_kernel_intervals(spans, busy):
    from dct_carver_tpu.utils.profiling import busy_ns

    assert busy_ns(spans) == busy
