"""Worker process for the real multi-PROCESS tests (test_multiprocess.py).

Each worker is an independent Python process with its own 4-device CPU
backend; `jax.distributed.initialize` joins them into one 2-process /
8-device multi-controller job — the same execution model as two hosts of
accelerators, minus their interconnect.  This is what turns parallel.multihost and
utils.checkpoint.save_sharded's "each host writes only its own shards"
claims into executed code (SURVEY §4 "multi-host without a cluster").

Invoked as:  python multiproc_worker.py <pid> <nproc> <port> <scenario> <dir>
Markers printed on stdout are asserted by the parent test.
Exits via os._exit after flushing to avoid distributed-shutdown hangs when a
peer was deliberately wedged or killed (the point of the health scenarios).
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def log(*args):
    print(*args, flush=True)


def main():
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = sys.argv[3]
    scenario = sys.argv[4]
    workdir = sys.argv[5]

    from dct_carver_tpu.parallel import multihost

    multihost.initialize(f"localhost:{port}", nproc, pid)
    assert multihost.is_distributed()
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == 4 * nproc
    multihost.barrier("startup")
    log("READY")

    if scenario == "killpeer":
        # peer 1 is SIGKILLed by the parent right after READY; the survivor's
        # probe must time out (the liveness signal) rather than hang forever
        if pid == 0:
            import time

            time.sleep(1.0)
            h = multihost.process_health(timeout=4.0)
            # a SIGKILLed peer surfaces either as a transport error
            # (fail-fast) or as a timeout — both are unhealthy
            assert not h["healthy"], h
            assert h["timed_out"] or h["error"], h
            log("HEALTH_DEAD_PEER_OK")
        else:
            import time

            time.sleep(600)  # parent kills us long before this
        sys.stdout.flush()
        os._exit(0)

    if scenario == "scale":
        # time the marginal per-seam cost of the sharded carve on the
        # 2-process mesh; the parent compares against a 1-process run of
        # the same shape at the same device count (controller overhead)
        import time

        from dct_carver_tpu.parallel.mesh import make_mesh
        from dct_carver_tpu.parallel.spatial import spatial_carve_n_seams

        rng = np.random.default_rng(0)
        luma = rng.random((256, 2048), dtype=np.float32)
        mesh = make_mesh(axis_name="x")

        def run(n):
            r = spatial_carve_n_seams(luma, n, mesh=mesh)
            jax.block_until_ready(r.width)

        n = 8
        run(n)   # compile
        t0 = time.perf_counter(); run(n); t1 = time.perf_counter() - t0
        run(2 * n)
        t0 = time.perf_counter(); run(2 * n); t2 = time.perf_counter() - t0
        log(f"MARGINAL_MS_PER_SEAM {(t2 - t1) / n * 1e3:.3f}")
        multihost.barrier("scale-done")
        log("DONE")
        sys.stdout.flush()
        os._exit(0)

    # ---- scenario "carve": distributed spatial carve + sharded checkpoint
    from dct_carver_tpu.parallel.mesh import make_mesh
    from dct_carver_tpu.parallel.spatial import spatial_carve_n_seams
    from dct_carver_tpu.ops.carve import carve_n_seams

    rng = np.random.default_rng(0)  # same seed everywhere -> same host array
    img = rng.integers(0, 256, size=(16, 64, 3), dtype=np.uint8)
    from dct_carver_tpu.oracle import reference as oracle

    luma = np.asarray(oracle.luma_bt709(img), np.float32)
    n = 4

    mesh = make_mesh(axis_name="x")  # all 8 global devices
    assert mesh.devices.size == 8

    ck = os.path.join(workdir, "ck")
    res = spatial_carve_n_seams(luma, n, mesh=mesh, chunk=2,
                                checkpoint_dir=ck)

    # parity vs a locally computed single-device reference, checked on the
    # shards THIS process can address (the full array is not addressable)
    ref = carve_n_seams(jnp.asarray(luma), n, 8, 0.0, 1.0,
                        strip_update=False)
    ref_vmap = np.asarray(ref.vmap)
    shards = res.vmap.addressable_shards
    assert len(shards) == 4
    for sh in shards:
        np.testing.assert_array_equal(np.asarray(sh.data),
                                      ref_vmap[sh.index])
    log("PARITY_OK")

    # each process must have written its own shard files (orbax OCDBT lays
    # them out per-process); both per-process dirs must exist
    step_dir = os.path.join(ck, "state-00000002")
    entries = set()
    for root, dirs, _files in os.walk(step_dir):
        entries.update(dirs)
    mine = [d for d in entries if d == f"ocdbt.process_{pid}"]
    other = [d for d in entries if d == f"ocdbt.process_{1 - pid}"]
    assert mine and other, sorted(entries)
    log("SHARDS_PER_PROCESS_OK")

    # resume from the mid-carve checkpoint on the same 2-process mesh;
    # restore is abstract (each host reads only its own shards)
    res2 = spatial_carve_n_seams(luma, n, mesh=mesh, resume_from=ck)
    for sh in res2.vmap.addressable_shards:
        np.testing.assert_array_equal(np.asarray(sh.data),
                                      ref_vmap[sh.index])
    assert int(res2.width) == 64 - n
    log("RESUME_OK")

    # ---- health probe: healthy case, then a wedged peer (timeout path)
    h = multihost.process_health(timeout=60.0)
    assert h["healthy"] and h["processes"] == nproc, h
    log("HEALTH_OK")

    import time

    if pid == 0:
        # peer deliberately wedged (sleeping): the probe's allgather cannot
        # complete within the deadline -> unhealthy report, no hang
        h = multihost.process_health(timeout=2.5)
        assert h["timed_out"] and not h["healthy"], h
        log("HEALTH_TIMEOUT_OK")
        # probing a wedged job again must NOT stack threads: the second
        # probe waits on the same outstanding collective
        import threading

        n_thr = threading.active_count()
        h2 = multihost.process_health(timeout=0.5)
        assert h2["timed_out"] and h2["probe_pending"], h2
        assert threading.active_count() == n_thr
        log("PROBE_REUSE_OK")
        time.sleep(6.0)  # let the wedged peer release the orphaned probe
    else:
        time.sleep(6.0)
        # complete the probe collective so process 0's orphaned probe thread
        # finishes (detection is non-destructive: the job can continue)
        from jax.experimental import multihost_utils

        multihost_utils.process_allgather(np.ones((1,), np.int32))

    log("DONE")
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
