"""The platform module is the one place that picks an implementation."""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dct_carver_tpu import platform
from dct_carver_tpu.ops import carve as carve_ops


def test_cpu_host_runs_the_scan():
    assert jax.default_backend() == "cpu"
    assert not platform.on_gpu()
    assert not platform.seam_dp_kernel(1920)


@pytest.mark.parametrize("W,dx,rig,want", [
    (1920, 1, 0.0, True),    # the headline shape
    (2160, 1, 0.0, True),    # config 3's height pass
    (platform.MAX_KERNEL_WIDTH, 1, 0.0, True),
    (platform.MAX_KERNEL_WIDTH + 1, 1, 0.0, False),  # too wide: scan
    (1, 1, 0.0, False),      # nothing to carve
    (1920, 2, 0.0, False),   # generalized recurrence: scan
    (1920, 1, 0.5, False),
])
def test_seam_dp_choice_on_gpu(monkeypatch, W, dx, rig, want):
    monkeypatch.setattr(platform, "on_gpu", lambda: True)
    assert platform.seam_dp_kernel(W, dx, rig) is want


def test_interpret_argument_selects_the_kernel_off_gpu():
    assert platform.seam_dp_kernel(256, interpret=True)
    assert not platform.seam_dp_kernel(256, delta_x=3, interpret=True)


def test_carve_asks_the_platform(monkeypatch, rng):
    """carve_n_seams traces the kernel exactly when the platform says so."""
    luma = jnp.asarray(rng.random((16, 48)).astype(np.float32))
    seen = []

    def spy(W, delta_x=1, rigidity=0.0, interpret=False):
        seen.append((W, delta_x, rigidity, interpret))
        return interpret

    monkeypatch.setattr(platform, "seam_dp_kernel", spy)
    jaxpr = jax.make_jaxpr(lambda l: carve_ops.carve_n_seams.__wrapped__(
        l, 2, 8, 0.0, 1.0, interpret=True))(luma)
    assert seen == [(48, 1, 0.0, True)]
    assert "pallas_call" in str(jaxpr)
    jaxpr = jax.make_jaxpr(lambda l: carve_ops.carve_n_seams.__wrapped__(
        l, 2, 8, 0.0, 1.0))(luma)
    assert "pallas_call" not in str(jaxpr)


def test_no_implementation_selector_in_the_api():
    """Which implementation runs is not a user option anywhere."""
    from dct_carver_tpu.parallel import mesh, spatial
    from dct_carver_tpu.utils.config import CarverConfig

    names = {f.name for f in dataclasses.fields(CarverConfig)}
    for fn in (carve_ops.carve_n_seams.__wrapped__, mesh.carve_batch,
               mesh.batch_carve_states.__wrapped__,
               spatial.spatial_carve_n_seams,
               spatial.spatial_enlarge_n_seams):
        names |= set(inspect.signature(fn).parameters)
    assert not [n for n in names if "pallas" in n or "kernel" in n]
