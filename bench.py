"""Benchmark harness — prints ONE JSON line with the headline metric.

Headline (BASELINE.md): single-seam retargeting throughput in Mpix/s on one
chip — pixels of image processed per second of seam-carving, i.e.
(H * W * n_seams) / elapsed.  Target >= 100 Mpix/s per chip → vs_baseline =
value / 100.

The DEFAULT run also emits, on stderr (one line each):
  * BASELINE.md configs 1-4 (config 4 = the vmapped carve over the mesh);
  * config 5's spatial path (on one device the mesh is 1-wide; the
    multi-device exchange is checked by `chip_smoke.py --four` and tests).
Every timing ends in `block_until_ready`; a failing config fails the run.

Run: python bench.py              headline + configs 1-5
     python bench.py --quick      small shapes, smoke test
     python bench.py --headline   headline only (old default behavior)
     python bench.py --config N   BASELINE config N in {1,2,3,4,5}
"""

import json
import os
import sys
import time

import jax
import numpy as np

# 8 virtual CPU host devices alongside the accelerator: config 5 compiles
# its seam step for an 8-way CPU mesh to COUNT the collectives in the HLO
# (a 1-device mesh has none)
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()


def _mk_lumas(rng, h, w, k=4, channels=3):
    import jax
    import jax.numpy as jnp
    from dct_carver_tpu.ops.energy import to_luma

    to_luma_j = jax.jit(to_luma)
    shape = (h, w) if channels is None else (h, w, channels)
    return [
        jax.block_until_ready(to_luma_j(jnp.asarray(
            rng.integers(0, 256, size=shape, dtype=np.uint8)
        )))
        for _ in range(k)
    ]


def _time_carve(lumas, n_seams, blocksize, strip_update=True, repeats=3):
    """lumas: list of distinct same-shape planes; the timed runs cycle
    through them."""
    from dct_carver_tpu.ops.carve import carve_n_seams

    def run(x):
        return jax.block_until_ready(carve_n_seams(
            x, n_seams, blocksize, 0.0, 1.0, strip_update=strip_update))

    run(lumas[0])  # compile
    best = float("inf")
    for i in range(repeats):
        x = lumas[(i + 1) % len(lumas)]
        t0 = time.perf_counter()
        run(x)
        best = min(best, time.perf_counter() - t0)
    h, w = lumas[0].shape
    mpix_s = h * w * n_seams / best / 1e6
    return mpix_s, best


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def bench_config_1(rng):
    """512x512 gray, 8x8, 64 vertical seams + native CPU reference time."""
    lumas = _mk_lumas(rng, 512, 512, channels=None)
    v, t = _time_carve(lumas, 64, 8)
    line = f"# config1 512x512 gray 64 seams: {v:.1f} Mpix/s ({t*1e3:.1f} ms)"
    try:
        from dct_carver_tpu.utils.native import carve_native

        luma64 = np.asarray(lumas[0], np.float64)
        t0 = time.perf_counter()
        carve_native(luma64, 64, 8, 0.0, 1.0)
        tc = time.perf_counter() - t0
        line += (f"; native 1-core CPU ref {512*512*64/tc/1e6:.1f} Mpix/s "
                 f"-> {jax.devices()[0].device_kind} {tc/t:.0f}x")
    except Exception as e:
        line += f"; native ref unavailable: {e}"
    _log(line)
    return v


def bench_config_2(rng):
    """1080p RGB, 8x8, 20% width reduction (384 seams)."""
    lumas = _mk_lumas(rng, 1080, 1920, k=3)
    v, t = _time_carve(lumas, 384, 8, repeats=2)
    _log(f"# config2 1080p 20% width (384 seams): {v:.1f} Mpix/s ({t:.2f} s)")
    return v


def bench_config_3(rng):
    """4K, 16x16 blocks, bidirectional (vertical + horizontal passes)."""
    import jax
    import jax.numpy as jnp
    from dct_carver_tpu.ops.carve import carve_n_seams

    h, w, n = 2160, 3840, 32
    lumas = _mk_lumas(rng, h, w, k=2)

    def run(x):
        st = carve_n_seams(x, n, 16, 0.0, 1.0)
        # horizontal pass on the transposed result (liblqr order: width first)
        st2 = carve_n_seams(jnp.swapaxes(st.luma[:, : w - n], 0, 1), n, 16,
                            0.0, 1.0)
        jax.block_until_ready(st2)

    run(lumas[0])
    t0 = time.perf_counter()
    run(lumas[1])
    t = time.perf_counter() - t0
    v = h * w * 2 * n / t / 1e6
    _log(f"# config3 4K 16x16 bidirectional (2x{n} seams): {v:.1f} Mpix/s "
         f"({t:.2f} s)")
    return v


def bench_config_4(rng):
    """Batch of 1-Mpix images, 128 seams each, sharded over the mesh — the
    vmapped carve, whose seam DP runs one kernel program per image on a GPU.
    (B = 16; BASELINE's 1024 images are not run yet.)"""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from dct_carver_tpu.parallel.mesh import carve_batch, make_mesh

    B, h, w = 16, 1024, 1024
    mesh = make_mesh()
    sharding = NamedSharding(mesh, P("data"))
    # pre-stage the batches on device: the host->device copy is not carve
    # throughput
    batches = [
        jax.block_until_ready(jax.device_put(
            jnp.asarray(rng.integers(0, 256, size=(B, h, w, 3),
                                     dtype=np.uint8)), sharding))
        for _ in range(2)
    ]
    jax.block_until_ready(
        carve_batch(batches[0], 128, mesh=mesh, reconstruct=False)[1])
    best = float("inf")
    for i in range(2):
        t0 = time.perf_counter()
        jax.block_until_ready(carve_batch(batches[(i + 1) % 2], 128,
                                          mesh=mesh, reconstruct=False)[1])
        best = min(best, time.perf_counter() - t0)
    v = B * h * w * 128 / best / 1e6
    _log(f"# config4 batch {B}x1Mpix, 128 seams: {v:.1f} Mpix/s ({best:.2f} s) "
         f"over {len(jax.devices())} device(s)")
    return v


def bench_config_5(rng):
    """Spatially-sharded single image (BASELINE config 5: 8K panorama).
    On one chip the mesh is 1-wide (collectives degenerate); the bench
    records throughput + the collective budget per seam of the design."""
    import jax
    import jax.numpy as jnp
    from dct_carver_tpu.parallel.mesh import make_mesh
    from dct_carver_tpu.parallel.spatial import (
        spatial_carve_n_seams, collectives_per_seam,
    )

    h, w, n = 4320, 7680, 64
    mesh = make_mesh(axis_name="x")
    nsh = mesh.shape["x"]
    lumas = _mk_lumas(rng, h, w, k=2)

    def run(x, nn):
        jax.block_until_ready(
            spatial_carve_n_seams(x, nn, blocksize=8, mesh=mesh).vmap)

    run(lumas[0], n)
    t0 = time.perf_counter()
    run(lumas[1], n)
    t = time.perf_counter() - t0
    v = h * w * n / t / 1e6
    # marginal per-seam cost (fixed init-energy + readback amortized out)
    run(lumas[0], 2 * n)
    t0 = time.perf_counter()
    run(lumas[1], 2 * n)
    t2 = time.perf_counter() - t0
    marginal = (t2 - t) / n * 1e3
    coll = collectives_per_seam(h)
    # the collective count, counted in the HLO of one unrolled seam step
    # compiled for an 8-way CPU mesh at the full 8K shape
    from jax.sharding import Mesh
    from dct_carver_tpu.parallel.spatial import measure_collectives_per_seam

    # keep CPU compiles out of the persistent cache the GPU runs use
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        m = measure_collectives_per_seam(
            h, w, Mesh(np.array(jax.devices("cpu")[:8]), ("x",)))
    finally:
        jax.config.update("jax_enable_compilation_cache", True)
    meas = (f"measured {m['total']}/seam in 8-way HLO "
            f"({', '.join(f'{k}={v2}' for k, v2 in m['by_op'].items())})")
    _log(f"# config5 8K spatial ({nsh} shard(s), {n} seams): {v:.1f} Mpix/s "
         f"({t:.2f} s, marginal {marginal:.1f} ms/seam); {meas}; "
         f"designed {coll}/seam (vs {3*h} per-row design)")
    return v


def main():
    quick = "--quick" in sys.argv
    headline_only = "--headline" in sys.argv
    cfg = None
    if "--config" in sys.argv:
        cfg = int(sys.argv[sys.argv.index("--config") + 1])
    from dct_carver_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    dev = jax.devices()[0]
    _log(f"# device: {dev.platform} {getattr(dev, 'device_kind', '?')} "
         f"x{len(jax.devices())}")

    rng = np.random.default_rng(0)

    if cfg is not None:
        fn = {1: bench_config_1, 2: bench_config_2, 3: bench_config_3,
              4: bench_config_4, 5: bench_config_5}.get(cfg)
        if fn is None:
            _log(f"# unknown config {cfg}")
            return
        v = fn(rng)
        print(json.dumps({
            "metric": f"config{cfg}_throughput", "value": round(v, 2),
            "unit": "Mpix/s", "vs_baseline": round(v / 100.0, 3),
        }))
        return

    if quick:
        h, w, seams = 256, 384, 8
    else:
        h, w, seams = 1080, 1920, 64  # config 2 shape, 8x8 blocks

    # best of 6 timed draws over 7 distinct inputs
    lumas = _mk_lumas(rng, h, w, k=7)
    headline, t = _time_carve(lumas, seams, 8, strip_update=True, repeats=6)
    _log(f"# headline {h}x{w} 8x8 strip-update: {headline:.1f} Mpix/s "
         f"({seams} seams in {t*1e3:.1f} ms, {t/seams*1e3:.3f} ms/seam)")

    if not quick and not headline_only:
        for fn in (bench_config_1, bench_config_2, bench_config_3,
                   bench_config_4, bench_config_5):
            fn(rng)

    print(json.dumps({
        "metric": "single_seam_retarget_throughput",
        "value": round(headline, 2),
        "unit": "Mpix/s",
        "vs_baseline": round(headline / 100.0, 3),
    }))


if __name__ == "__main__":
    main()
