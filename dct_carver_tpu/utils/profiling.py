"""Profiling: `jax.profiler` traces and the reduction from a trace to
device time per name scope (SURVEY §5: the reference has none).

Device time comes from the trace, never from the host clock: every kernel
the device ran is an event on a stream line of a `/device:` plane.  A
kernel is attributed to a name scope (`jax.named_scope`, e.g. "seam_dp")
through the `op_name` metadata of the HLO instruction it runs, read from
the compiled module's text; XLA:GPU names a fusion's kernel after the
fusion instruction, and a Pallas kernel after its `name`.
"""

from __future__ import annotations

import contextlib
import glob
import os
import re

import jax

__all__ = ["trace", "busy_ns", "device_time_ms", "profile_carve"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace (view with TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def _key(name: str) -> str:
    return re.sub(r"[^0-9A-Za-z]", "_", name)


def _kernel_op_names(hlo_text: str) -> dict:
    """Kernel name -> op_name metadata of the instruction it runs."""
    out = {}
    for m in re.finditer(
            r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?metadata=\{[^}]*?"
            r"op_name=\"([^\"]*)\"", hlo_text, re.M):
        out[_key(m.group(1))] = m.group(2)
    return out


def busy_ns(intervals) -> int:
    """Length of the union of (start, end) intervals: time the device was
    busy, counting kernels that overlap on several streams once."""
    busy, reach = 0, None
    for start, end in sorted(intervals):
        if reach is None or start > reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    return busy


def device_time_ms(log_dir: str, hlo_text: str, scope: str):
    """(device ms of kernels inside `scope`, device busy ms, device events)
    for the newest trace under `log_dir`; busy time is the union over all
    streams of the kernels' intervals.  `hlo_text` is `compiled.as_text()`
    of the traced program."""
    from jax.profiler import ProfileData

    files = glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not files:
        raise FileNotFoundError(f"no trace under {log_dir}")
    op_names = _kernel_op_names(hlo_text)
    inside, spans = 0, []
    for plane in ProfileData.from_file(max(files, key=os.path.getmtime)).planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                spans.append((ev.start_ns, ev.end_ns))
                if scope in ev.name or scope in op_names.get(_key(ev.name),
                                                              ""):
                    inside += ev.duration_ns
    return inside / 1e6, busy_ns(spans) / 1e6, len(spans)


def profile_carve(luma, n_seams: int, blocksize: int = 8, *, log_dir: str):
    """Trace one full carve for kernel-level inspection."""
    import jax.numpy as jnp
    from ..ops.carve import carve_n_seams

    with trace(log_dir):
        state = jax.block_until_ready(
            carve_n_seams(jnp.asarray(luma), n_seams, blocksize, 0.0, 1.0))
    return state
