#!/usr/bin/env python3
"""Judge the seam-DP kernel against XLA's scan on one GPU, in one process.

For each cell (1080p x 64 seams, 1080p x 384 seams, 16 x 1024x1024 x 128
seams, 8x8 blocks) the same carve program is built twice, differing only in
the DP: once as `dct_carver_tpu.platform` picks it (the kernel on a GPU),
once with the DP forced to the scan.  Timed runs alternate scan, kernel,
kernel, scan, each ending in `block_until_ready`.  Then the same program at
the same seam count runs once more under `jax.profiler`: its device busy
time and the time of the ops under the "seam_dp" name scope, divided by the
seam count, and the idle share 1 - busy / (median timed wall).  The scan is
traced only in the 1080p x 64 cell: it launches ~8,700 kernels per 1080p
seam, so at 384 seams or on the batch its trace would hold millions of
events; those figures print as null (not measured).  Prints one JSON line
per cell.

    python scripts/compare_dp.py [--traces DIR]
    python scripts/compare_dp.py --warps

`--warps` instead times the kernel alone (one `seam_call`, no carve) at 4,
8, 16 and 32 warps per program, and XLA's scan alone, on the energy of a
1080p photo, a 4K photo and 16 1-Mpix photos: median wall ms per call over
20 calls, each ending in `block_until_ready`; every seam is checked bitwise
against the scan.  Traces go to a temporary directory unless --traces names
one to keep.
"""

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dct_carver_tpu import platform  # noqa: E402
from dct_carver_tpu.ops import carve as carve_ops  # noqa: E402
from dct_carver_tpu.ops import dp  # noqa: E402
from dct_carver_tpu.pallas import seam_dp  # noqa: E402
from dct_carver_tpu.utils.cache import enable_compilation_cache  # noqa: E402
from dct_carver_tpu.utils.profiling import device_time_ms, trace  # noqa: E402

WARPS = (4, 8, 16, 32)
SWEEP_CALLS = 20


@contextlib.contextmanager
def dp_choice(kernel: bool):
    """While tracing, keep the platform's DP choice (kernel) or force the
    scan; the choice is static, so it is fixed in the compiled program."""
    saved = platform.seam_dp_kernel
    if not kernel:
        platform.seam_dp_kernel = lambda *a, **k: False
    try:
        yield
    finally:
        platform.seam_dp_kernel = saved


def build(kernel: bool, batched: bool):
    raw = carve_ops.carve_n_seams.__wrapped__  # the un-jitted carve

    def carve(lumas, n):
        with dp_choice(kernel):
            one = lambda l: raw(l, n, 8, 0.0, 1.0).vmap
            return jax.vmap(one)(lumas) if batched else one(lumas)

    return jax.jit(carve, static_argnames="n")


def photo_lumas(k, h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for _ in range(k):
        img = (xx * rng.uniform(0.5, 2) + 30 * np.sin(yy / rng.uniform(5, 15))
               + 60 * (((xx // rng.integers(40, 90) + yy // 50) % 3) == 0)
               + rng.normal(0, 5, (h, w)))
        out.append(((img % 256) / 255.0).astype(np.float32))
    return jnp.asarray(np.stack(out))


def run_cell(name, lumas, n, batched, trace_scan, out_dir):
    fns = {"scan": build(False, batched), "kernel": build(True, batched)}
    inputs = [lumas[0], lumas[1]] if not batched else [lumas]
    compile_s, times = {}, {"scan": [], "kernel": []}
    for v, f in fns.items():
        t = time.perf_counter()
        jax.block_until_ready(f(inputs[0], n))
        compile_s[v] = time.perf_counter() - t
    for v in ("scan", "kernel", "kernel", "scan"):
        for x in inputs:
            t = time.perf_counter()
            jax.block_until_ready(fns[v](x, n))
            times[v].append(time.perf_counter() - t)
    row = {"cell": name, "seams": n,
           "images": int(lumas.shape[0]) if batched else 1,
           "e2e_s": times, "e2e_ms_per_seam": {},
           "device_busy_ms_per_seam": {}, "dp_device_ms_per_seam": {},
           "idle_share": {}, "device_events": {}, "traced_wall_s": {},
           "compile_plus_first_run_s": compile_s}
    for v, f in fns.items():
        med_ms = statistics.median(times[v]) * 1e3
        row["e2e_ms_per_seam"][v] = med_ms / n
        for k in ("device_busy_ms_per_seam", "dp_device_ms_per_seam",
                  "idle_share", "device_events", "traced_wall_s"):
            row[k][v] = None
        if v == "scan" and not trace_scan:
            continue
        d = os.path.join(out_dir, f"{name}_{v}")
        x = inputs[0]
        t = time.perf_counter()
        with trace(d):
            jax.block_until_ready(f(x, n))
        row["traced_wall_s"][v] = time.perf_counter() - t
        hlo = f.lower(x, n).compile().as_text()
        dp_ms, busy_ms, events = device_time_ms(d, hlo, "seam_dp")
        row["dp_device_ms_per_seam"][v] = dp_ms / n
        row["device_busy_ms_per_seam"][v] = busy_ms / n
        row["idle_share"][v] = 1 - busy_ms / med_ms
        row["device_events"][v] = events
    return row


def median_call_ms(f, *args):
    for _ in range(3):
        jax.block_until_ready(f(*args))
    ts = []
    for _ in range(SWEEP_CALLS):
        t = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t)
    return statistics.median(ts) * 1e3


def warps_sweep():
    """One JSON line per energy shape: the kernel alone at each warps count
    and the scan alone, median wall ms per call."""
    energy = jax.jit(jax.vmap(
        lambda l: carve_ops.full_energy_map(l, 8, 0.0, 1.0)))
    scan = jax.jit(jax.vmap(
        lambda e: dp.backtrack(dp.cumulative_energy(e))))
    for name, lumas in (("1080p", photo_lumas(1, 1080, 1920, seed=0)),
                        ("4k", photo_lumas(1, 2160, 3840, seed=2)),
                        ("batch16_1mpix", photo_lumas(16, 1024, 1024,
                                                      seed=1))):
        E = energy(lumas)
        B, H, W = E.shape
        flat = E.reshape(B, H * W)
        width = jnp.full((B, 1), W, jnp.int32)
        ref = np.asarray(scan(E))
        row = {"sweep": name, "images": B, "H": H, "W": W,
               "rule_warps": seam_dp.num_warps(W), "calls": SWEEP_CALLS,
               "scan_ms": median_call_ms(scan, E), "kernel_ms": {}}
        for warps in WARPS:
            call = seam_dp.seam_call(H, W, "leftmost", warps)
            f = jax.jit(jax.vmap(lambda w, e: call(w, e)[1]))
            np.testing.assert_array_equal(np.asarray(f(width, flat)), ref,
                                          err_msg=f"{name} warps={warps}")
            row["kernel_ms"][warps] = median_call_ms(f, width, flat)
        yield row


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--traces", default=None,
                    help="keep the profiler traces in this directory")
    ap.add_argument("--warps", action="store_true",
                    help="time the kernel alone at each warps count instead")
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"compare_dp: needs a GPU; JAX found {dev.platform}")
    enable_compilation_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"# {dev.device_kind} x{len(jax.devices())}; nvidia-smi: {smi}",
          flush=True)
    if args.warps:
        for row in warps_sweep():
            row.update(device=dev.device_kind, card=smi)
            print(json.dumps(row), flush=True)
        return
    hd = photo_lumas(2, 1080, 1920, seed=0)
    cells = [("1080p_64", hd, 64, False, True),
             ("1080p_384", hd, 384, False, False),
             ("batch16_1mpix_128", photo_lumas(16, 1024, 1024, seed=1), 128,
              True, False)]
    with tempfile.TemporaryDirectory() as tmp:
        for name, lumas, n, batched, trace_scan in cells:
            row = run_cell(name, lumas, n, batched, trace_scan,
                           args.traces or tmp)
            row.update(device=dev.device_kind, card=smi)
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
