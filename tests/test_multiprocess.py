"""REAL multi-process execution (jax.process_count() == 2) of the sharded
spatial carve, the orbax per-host checkpoint, and the liveness probe.

Everything else in the suite runs one process over a virtual 8-device mesh;
these tests spawn two OS processes with their own 4-device CPU backends and
join them with `jax.distributed.initialize` through a local coordinator —
the multi-controller execution model of two accelerator hosts (SURVEY §4
"multi-host without a cluster").  BASELINE's 2-host axis needs a second
host, which the test environment lacks; this is the strongest available
substitute.
"""

import os
import signal
import socket
import subprocess
import sys

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "multiproc_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(pid, nproc, port, scenario, workdir):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    return subprocess.Popen(
        [sys.executable, _WORKER, str(pid), str(nproc), str(port),
         scenario, workdir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
    )


def test_two_process_spatial_carve_checkpoint_health(tmp_path):
    """2-process distributed run: spatial carve parity on each process's
    addressable shards, per-process orbax shard writes, abstract sharded
    resume, healthy probe, and the wedged-peer timeout probe."""
    port = _free_port()
    procs = [_spawn(i, 2, port, "carve", str(tmp_path)) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"proc {i} rc={rc}\nstdout:\n{out}\nstderr:\n{err}"
        for marker in ("READY", "PARITY_OK", "SHARDS_PER_PROCESS_OK",
                       "RESUME_OK", "HEALTH_OK", "DONE"):
            assert marker in out, f"proc {i} missing {marker}\n{out}\n{err}"
    assert "HEALTH_TIMEOUT_OK" in outs[0][1]
    assert "PROBE_REUSE_OK" in outs[0][1]


def test_two_process_killed_peer_detected(tmp_path):
    """SIGKILL one process after startup; the survivor's liveness probe must
    report unhealthy within its deadline instead of hanging."""
    port = _free_port()
    p0 = _spawn(0, 2, port, "killpeer", str(tmp_path))
    p1 = _spawn(1, 2, port, "killpeer", str(tmp_path))
    try:
        # wait for p1 to reach READY (past the startup barrier), then kill it
        import threading

        lines = []
        got_ready = threading.Event()

        def reader():
            for line in p1.stdout:
                lines.append(line)
                if "READY" in line:
                    got_ready.set()

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        assert got_ready.wait(300), f"p1 never reached READY: {lines}"
        p1.send_signal(signal.SIGKILL)

        out, err = p0.communicate(timeout=300)
        assert p0.returncode == 0, f"rc={p0.returncode}\n{out}\n{err}"
        assert "HEALTH_DEAD_PEER_OK" in out, f"{out}\n{err}"
    finally:
        for p in (p0, p1):
            if p.poll() is None:
                p.kill()


def test_two_process_scaling_overhead(tmp_path):
    """BASELINE's 2-host scaling axis, in-environment form: the same
    sharded carve at the same TOTAL device count, run single-controller
    (1 process x 8 devices) vs multi-controller (2 processes x 4 devices,
    collectives through a real cross-process backend — Gloo over local
    TCP).  This MEASURES the per-collective cost of the cross-process
    fabric.  The TCP fabric is far slower per collective than a device
    interconnect such as NVLink, so no tight
    efficiency bound applies here — the assertions are that the
    multi-controller run works and that the overhead is explained by the
    collective count (cost/collective in a plausible TCP range)."""
    import re
    import subprocess

    # single-process reference, same shape/devices
    code = r"""
import os, sys, time
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, %r)
import jax; jax.config.update("jax_platforms", "cpu")
import numpy as np
from dct_carver_tpu.parallel.mesh import make_mesh
from dct_carver_tpu.parallel.spatial import spatial_carve_n_seams
rng = np.random.default_rng(0)
luma = rng.random((256, 2048), dtype=np.float32)
mesh = make_mesh(axis_name="x")
def run(n):
    r = spatial_carve_n_seams(luma, n, mesh=mesh)
    jax.block_until_ready(r.width)
n = 8
run(n)
t0 = time.perf_counter(); run(n); t1 = time.perf_counter() - t0
run(2 * n)
t0 = time.perf_counter(); run(2 * n); t2 = time.perf_counter() - t0
print(f"MARGINAL_MS_PER_SEAM {(t2 - t1) / n * 1e3:.3f}", flush=True)
""" % os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    single = subprocess.run([sys.executable, "-c", code], env=env,
                            capture_output=True, text=True, timeout=600)
    assert single.returncode == 0, single.stderr
    ms1 = float(re.search(r"MARGINAL_MS_PER_SEAM (-?[\d.]+)",
                          single.stdout).group(1))

    port = _free_port()
    procs = [_spawn(i, 2, port, "scale", str(tmp_path)) for i in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"{out}\n{err}"
        assert "DONE" in out
    ms2 = float(re.search(r"MARGINAL_MS_PER_SEAM (-?[\d.]+)",
                          outs[0][0]).group(1))
    if ms1 <= 0 or ms2 <= 0:
        import pytest

        pytest.skip(f"host too loaded for differential timing "
                    f"(ms1={ms1}, ms2={ms2})")
    from dct_carver_tpu.parallel.spatial import collectives_per_seam

    n_coll = collectives_per_seam(256)
    per_coll_ms = (ms2 - ms1) / n_coll
    print(f"single-controller {ms1:.2f} ms/seam, "
          f"2-process {ms2:.2f} ms/seam over {n_coll} collectives/seam -> "
          f"{per_coll_ms*1e3:.0f} us/collective on the TCP fabric")
    # the overhead must be collective-latency shaped: per-collective cost
    # in a plausible cross-process-TCP range (not, say, a recompilation
    # per seam, which would be hundreds of ms per collective).  Lower
    # bound is 0 (host-load noise can make the two runs comparable).
    assert per_coll_ms < 60.0, (ms1, ms2, per_coll_ms)
