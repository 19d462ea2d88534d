#!/usr/bin/env python3
"""Smoke test of the carve on NVIDIA GPUs, through the entry points a user
calls, at the deployments' real sizes.  One process drives the card(s).

    python chip_smoke.py          one GPU: CLI, parity, batch, 4K, kernels
    python chip_smoke.py --four   four GPUs: the sharded 8K carve and the
                                  sharded batch, each against one GPU

Phases (one GPU):
  1. device: the card, JAX, XLA_FLAGS, the compile-cache directory;
  2. CLI: `dct-carver carve` of a seeded 1920x1080 RGB photo by -384 seams;
  3. parity: `api.carve` at 1080p x 384 seams, both tie rules, against the
     native f32-chain carver (identical visibility maps);
  4. batch: `carve_batch` of 16 x 1024x1024 RGB by 128 seams against
     single-image `carve_n_seams`;
  5. 4K: `Carver.resize` with 16x16 blocks by -32 in both directions; the
     width pass against the native carver;
  6. kernels: the `chip` tests (tests/test_chip.py) and the 1080p carve's
     memory analysis.

Any failure raises and exits non-zero.  The last line of standard output is
one JSON object naming the device; it is printed only when every phase
passed.  Without a GPU the script exits non-zero before any phase.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def photo(h: int, w: int, seed: int):
    """Seeded photo-like RGB (gradients, blocks, discs, texture, noise);
    R and B never 0, so a seam overlay's pure-green pixels are countable."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 90 + 60 * np.sin(xx / (w / 7.0)) + 40 * np.cos(yy / (h / 5.0))
    tex = 18 * np.sin(xx / 3.1 + yy / 4.7) * (((xx // 64 + yy // 48) % 3) == 0)
    img = np.stack([base + tex, base * 0.8 + 30, 200 - base * 0.5], -1)
    for _ in range(12):  # discs and blocks of flat colour
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        r = rng.integers(h // 20, h // 6)
        col = rng.integers(20, 235, 3)
        if rng.random() < 0.5:
            m = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        else:
            m = (abs(yy - cy) < r) & (abs(xx - cx) < 1.6 * r)
        img[m] = col
    img += rng.normal(0, 4, img.shape)
    return np.clip(img, 1, 255).astype(np.uint8)


def device_phase():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU; JAX found {devs[0].platform}")
    sys.path.insert(0, ROOT)
    from dct_carver_tpu.utils.cache import enable_compilation_cache

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    log(f"[device] {devs[0].device_kind} x{len(devs)}, jax {jax.__version__}")
    log(f"[device] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"compile cache {enable_compilation_cache()}")
    log(f"[device] nvidia-smi: {smi[0]}")
    return devs


def cli_phase(tmp: str):
    import numpy as np

    from dct_carver_tpu.cli import main as cli_main
    from dct_carver_tpu.utils.image import load_image, save_image

    src = os.path.join(tmp, "photo.ppm")
    out = os.path.join(tmp, "carved.ppm")
    seams = os.path.join(tmp, "seams.ppm")
    save_image(src, photo(1080, 1920, seed=1))
    t = time.perf_counter()
    rc = cli_main(["carve", src, out, "--seams", "-384", "--blocksize", "8",
                   "--output-seams", seams])
    dt = time.perf_counter() - t
    assert rc == 0, f"cli returned {rc}"
    carved, overlay = load_image(out), load_image(seams)
    assert carved.shape == (1080, 1536, 3), carved.shape
    per_row = ((overlay[..., 0] == 0) & (overlay[..., 2] == 0)).sum(axis=1)
    assert (per_row == 384).all(), np.unique(per_row)
    log(f"[cli] 1920x1080 -384 seams -> {carved.shape[1]}x{carved.shape[0]}, "
        f"384 seams in every row; {dt:.2f} s with compile")


def luma_of(img):
    """The luma plane the carve itself computes from `img`."""
    import numpy as np

    from dct_carver_tpu.models.carver import _to_luma_jit

    return np.asarray(_to_luma_jit(img, mode="bt709"))


def parity_phase():
    import jax
    import numpy as np

    from dct_carver_tpu import api
    from dct_carver_tpu.ops.carve import full_energy_map
    from dct_carver_tpu.utils.native import (carve_native_f32,
                                             energy_map_native_f32)

    img = photo(1080, 1920, seed=1)
    luma = luma_of(img)
    e_gpu = np.asarray(jax.jit(
        lambda l: full_energy_map(l, 8, 0.3, 0.7))(luma))
    e_nat = energy_map_native_f32(luma, 8, 0.3, 0.7)
    log(f"[parity] 1080p energy max |gpu - native| = "
        f"{float(np.abs(e_gpu - e_nat).max()):.3e}, differing pixels "
        f"{int((e_gpu != e_nat).sum())}")
    for tie in ("leftmost", "rightmost"):
        t = time.perf_counter()
        res = api.carve(img, -384, edges=0.3, textures=0.7, output_seams=True,
                        tie=tie)
        dt = time.perf_counter() - t
        ref = carve_native_f32(luma, 384, 8, 0.3, 0.7, tie=tie)
        diff = int((res.visibility_map != ref).sum())
        assert diff == 0, f"tie={tie}: {diff} vmap cells differ from native"
        assert res.image.shape == (1080, 1536, 3)
        log(f"[parity] 1080p x 384 seams tie={tie}: vmap identical to the "
            f"native f32 carver ({dt:.2f} s with compile)")


def batch_phase():
    import jax
    import numpy as np

    from dct_carver_tpu.ops.carve import carve_n_seams
    from dct_carver_tpu.parallel.mesh import carve_batch

    imgs = np.stack([photo(1024, 1024, seed=100 + i) for i in range(16)])
    t = time.perf_counter()
    out, vmaps = carve_batch(imgs, 128)
    out, vmaps = np.asarray(out), np.asarray(vmaps)
    dt = time.perf_counter() - t
    assert out.shape == (16, 1024, 896, 3), out.shape
    t = time.perf_counter()
    out, vmaps = carve_batch(imgs, 128)
    vmaps = np.asarray(jax.block_until_ready(vmaps))
    warm = time.perf_counter() - t
    for i in (0, 15):
        ref = carve_n_seams(luma_of(imgs[i]), 128, 8, 0.0, 1.0)
        assert np.array_equal(vmaps[i], np.asarray(ref.vmap)), f"image {i}"
    log(f"[batch] 16 x 1024x1024 x 128 seams: images 0 and 15 equal "
        f"single-image carves; {dt:.2f} s with compile, {warm:.2f} s warm")


def fourk_phase():
    from dct_carver_tpu.models.carver import Carver
    from dct_carver_tpu.utils.config import CarverConfig
    from dct_carver_tpu.utils.native import carve_native_f32

    img = photo(2160, 3840, seed=4)
    cfg = CarverConfig(blocksize=16, output_seams=True)
    t = time.perf_counter()
    res = Carver(img, cfg).resize(3840 - 32, 2160 - 32)
    first = time.perf_counter() - t
    t = time.perf_counter()
    Carver(img, cfg).resize(3840 - 32, 2160 - 32)
    warm = time.perf_counter() - t
    assert res.image.shape == (2128, 3808, 3), res.image.shape
    ref = carve_native_f32(luma_of(img), 32, 16, 0.0, 1.0)
    diff = int((res.visibility_map != ref).sum())
    assert diff == 0, f"4K width pass: {diff} vmap cells differ from native"
    log(f"[4k] 3840x2160 n=16 resize -32/-32 -> 3808x2128; width pass "
        f"identical to the native f32 carver; first call {first:.2f} s, warm "
        f"{warm:.2f} s (compile ~{first - warm:.2f} s)")


def kernel_phase():
    import jax
    import jax.numpy as jnp
    import pytest

    from dct_carver_tpu.ops.carve import carve_n_seams

    class Outcomes:
        """Counts test outcomes: a skipped chip test is a failure here."""
        def __init__(self):
            self.counts = {}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.counts[report.outcome] = \
                    self.counts.get(report.outcome, 0) + 1

    outcomes = Outcomes()
    os.environ["DCT_CARVER_CHIP_TESTS"] = "1"
    rc = pytest.main(["-q", "-m", "chip", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_chip.py")],
                     plugins=[outcomes])
    assert rc == 0 and set(outcomes.counts) == {"passed"}, \
        f"chip tests: pytest exit {rc}, outcomes {outcomes.counts}"
    compiled = carve_n_seams.lower(
        jax.ShapeDtypeStruct((1080, 1920), jnp.float32), 384, 8, 0.0, 1.0
    ).compile()
    log(f"[kernels] {outcomes.counts['passed']} chip tests passed; "
        f"1080p x 384 carve memory: "
        f"{compiled.memory_analysis()}")


def four_phase(h=4320, w=7680, n=64, batch=(16, 1024, 128)):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dct_carver_tpu.ops.carve import carve_n_seams
    from dct_carver_tpu.parallel.mesh import carve_batch, make_mesh
    from dct_carver_tpu.parallel.spatial import spatial_carve_n_seams

    assert len(jax.devices()) == 4, f"--four needs 4 GPUs, found " \
        f"{len(jax.devices())}"
    luma = jnp.asarray(luma_of(photo(h, w, seed=8)))
    t = time.perf_counter()
    single = np.asarray(carve_n_seams(luma, n, 8, 0.0, 1.0).vmap)
    t1 = time.perf_counter() - t
    t = time.perf_counter()
    res = spatial_carve_n_seams(luma, n, mesh=make_mesh(4, axis_name="x"))
    sharded = np.asarray(res.vmap)
    t4 = time.perf_counter() - t
    diff = int((single != sharded).sum())
    assert diff == 0, f"8K spatial: {diff} vmap cells differ from one GPU"
    assert int(res.width) == w - n
    log(f"[four] {w}x{h} x {n} seams over 4 GPUs identical to one GPU "
        f"(one GPU {t1:.2f} s, four {t4:.2f} s, both with compile)")

    b, side, bn = batch
    imgs = np.stack([photo(side, side, seed=100 + i) for i in range(b)])
    t = time.perf_counter()
    out1, vm1 = (np.asarray(a) for a in carve_batch(imgs, bn,
                                                     mesh=make_mesh(1)))
    t1 = time.perf_counter() - t
    t = time.perf_counter()
    out4, vm4 = (np.asarray(a) for a in carve_batch(imgs, bn,
                                                     mesh=make_mesh(4)))
    t4 = time.perf_counter() - t
    assert np.array_equal(vm1, vm4) and np.array_equal(out1, out4)
    log(f"[four] batch {b} x {side}x{side} x {bn} seams over 4 GPUs identical to "
        f"one GPU (one GPU {t1:.2f} s, four {t4:.2f} s, both with compile)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU paths and their one-GPU "
                         "references")
    args = ap.parse_args()
    devs = device_phase()
    with tempfile.TemporaryDirectory() as tmp:
        # the CLI keeps its last-used settings; keep them in the run's tmp
        os.environ["DCT_CARVER_STATE_DIR"] = tmp
        if args.four:
            four_phase()
        else:
            cli_phase(tmp)
            parity_phase()
            batch_phase()
            fourk_phase()
            kernel_phase()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
