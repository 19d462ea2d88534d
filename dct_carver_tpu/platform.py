"""The one place that decides which implementation runs each stage.

Every stage of the carve has a plain XLA form (`ops/`), which is the
semantics anchor and runs on any backend.  A stage gets a hand-written
kernel only where one measured faster end to end on an NVIDIA H100
(PERF.md).  Today that is the per-seam DP (`pallas/seam_dp.py`, Pallas
through Triton); energy, compaction, strip updates and the sharded path
are XLA on every platform.

The choice is static: it depends on the backend and the shapes, never on a
user option.  `interpret=True` (tests only, passed by argument) runs the
kernel through the Pallas interpreter so that hosts without a GPU can check
it against the scan.
"""

from __future__ import annotations

import jax

__all__ = ["on_gpu", "seam_dp_kernel", "MAX_KERNEL_WIDTH"]

# Widest buffer the seam-DP kernel takes: its row lives in registers, one
# 2^k block per program, and at 8192 columns a 32-warp block already holds
# 8 floats of each live row per thread.  Wider images take the scan.
MAX_KERNEL_WIDTH = 8192


def on_gpu() -> bool:
    return jax.default_backend() == "gpu"


def seam_dp_kernel(W: int, delta_x: int = 1, rigidity: float = 0.0,
                   interpret: bool = False) -> bool:
    """True when the per-seam DP (forward + backtrack) runs as the Pallas
    kernel instead of XLA's two row scans.  The kernel implements the
    reference recurrence (delta_x=1, rigidity=0); other DP parameters take
    the scan."""
    return ((on_gpu() or interpret) and delta_x == 1 and rigidity == 0.0
            and 2 <= W <= MAX_KERNEL_WIDTH)
