"""Test harness: run everything on a virtual 8-device CPU mesh (SURVEY §4).

Must set env vars BEFORE jax import anywhere in the test process.  Tests
marked `chip` need an NVIDIA GPU and skip elsewhere; `chip_smoke.py` runs
them on the card in its own process, with DCT_CARVER_CHIP_TESTS=1 so that
this file leaves the platform alone.
"""

import os
import sys

CHIP = os.environ.get("DCT_CARVER_CHIP_TESTS") == "1"
if not CHIP:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# keep CLI settings persistence (utils/settings.py) away from the real
# ~/.config — tests must not leak state between runs or into the user's env
import tempfile  # noqa: E402

os.environ["DCT_CARVER_STATE_DIR"] = tempfile.mkdtemp(prefix="dct_carver_test_")

import jax  # noqa: E402

if not CHIP:
    jax.config.update("jax_platforms", "cpu")
    # CPU compiles must never land in the persistent cache the program
    # keeps for the GPU (utils/cache.py)
    jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first device, when it is an NVIDIA GPU; skips the test
    otherwise.  Decided when the test runs, never at import or collection,
    so every worker collects the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: python chip_smoke.py)")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def random_u8_image(rng, h, w, c=None):
    shape = (h, w) if c is None else (h, w, c)
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


@pytest.fixture
def make_image(rng):
    def _make(h, w, c=None, kind="random"):
        if kind == "random":
            return random_u8_image(rng, h, w, c)
        if kind == "gradient":
            col = np.linspace(0, 255, w, dtype=np.float64)
            img = np.tile(col, (h, 1)).astype(np.uint8)
            if c:
                img = np.repeat(img[..., None], c, axis=-1)
            return img
        if kind == "flat":
            img = np.full((h, w) if c is None else (h, w, c), 128, dtype=np.uint8)
            return img
        if kind == "edges":
            img = random_u8_image(rng, h, w, c).astype(np.float64) * 0.2
            img[:, w // 3] = 255
            img[h // 3, :] = 255
            return img.astype(np.uint8)
        raise ValueError(kind)

    return _make
