"""Native C++ carver vs the NumPy oracle — three-way parity.

Includes the f32-chain family (`*_f32`): the native library replays the JAX
production path's exact f32 multiply-add order (ops/dct.py
`energy_from_bands`; compiled -ffp-contract=off), so the SHIPPING
configuration (f32 + strip updates) is proven seam-for-seam against an
independent implementation — not only against self-consistent JAX variants.
See docs/PARITY.md.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from dct_carver_tpu.oracle import reference as oracle
from dct_carver_tpu.utils.native import (
    native_available, energy_map_native, carve_native,
    energy_map_native_f32, carve_native_f32,
)

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native library failed to build"
)


def _structured_luma(kind: str, h: int, w: int, seed: int = 7) -> np.ndarray:
    """Photo-like f32 corpus — gradients / hard edges / blobby texture, NOT
    pure noise (near-ties cluster on noise; parity must hold on real content)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "gradient":
        img = xx * 2.0 + yy * 0.7
    elif kind == "edges":
        img = np.where((xx // 16 + yy // 16) % 2 == 0, 40.0, 210.0)
        img = img + rng.normal(0, 1.5, size=(h, w))
    else:  # "photo"
        img = xx * 1.2 + 30 * np.sin(yy / 9.0) + 25 * np.cos(xx / 13.0)
        img = img + rng.normal(0, 6, size=(h, w))
    return ((img % 256) / 255.0).astype(np.float32)


@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_native_energy_matches_oracle(n, make_image):
    img = make_image(24, 31, c=3)
    luma = oracle.luma_bt709(img)
    ref = oracle.energy_map(luma, n, 0.3, 0.9)
    got = energy_map_native(luma, n, 0.3, 0.9)
    # both compute the DCT in f64 and cast to f32; summation orders differ
    # (loops vs einsum) so allow 1-ulp — weight-class flips would be huge
    np.testing.assert_allclose(got, ref, rtol=3e-7, atol=1e-12)


@pytest.mark.parametrize("blocksize", [2, 4, 8, 16])
def test_native_carve_matches_oracle(blocksize, make_image):
    img = make_image(40, 48, c=3)
    luma = oracle.luma_bt709(img)
    n = 6
    _, ref_vmap, _ = oracle.carve_seams(img, n, blocksize, 0.3, 0.9)
    got_vmap = carve_native(luma, n, blocksize, 0.3, 0.9)
    np.testing.assert_array_equal(got_vmap, ref_vmap)


def test_native_carve_gray(make_image):
    img = make_image(32, 40)
    luma = oracle.luma_bt709(img)
    _, ref_vmap, _ = oracle.carve_seams(img, 10, 8, 0.0, 1.0)
    got = carve_native(luma, 10, 8, 0.0, 1.0)
    np.testing.assert_array_equal(got, ref_vmap)


def test_native_rejects_bad_args(make_image):
    luma = oracle.luma_bt709(make_image(16, 16))
    with pytest.raises(ValueError):
        carve_native(luma, 16, 8, 0.0, 1.0)  # n_seams >= W


@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_native_f32_energy_bitwise(n):
    """The f32-chain energy must be BIT-equal to the JAX f32 chain."""
    from dct_carver_tpu.ops.dct import dct_energy_map

    luma = _structured_luma("photo", 48, 64)
    got = energy_map_native_f32(luma, n, 0.3, 0.7)
    ref = np.asarray(dct_energy_map(jnp.asarray(luma), n, 0.3, 0.7))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", ["gradient", "edges", "photo"])
@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_native_f32_parity(kind, n):
    """SHIPPING config (f32 energy + f32 DP + strip updates) seam-for-seam
    vs the independent native f32-chain carver, structured corpus."""
    from dct_carver_tpu.ops.carve import carve_n_seams

    luma = _structured_luma(kind, 48, 64)
    seams = 12
    vm_native = carve_native_f32(luma, seams, n, 0.3, 0.7)
    state = carve_n_seams(jnp.asarray(luma), seams, n, 0.3, 0.7,
                          strip_update=True)
    np.testing.assert_array_equal(np.asarray(state.vmap), vm_native)


def test_native_f32_parity_pallas_interpret():
    """Same parity through the seam-DP kernel (Pallas interpreter on the
    CPU); kernel == scan is separately asserted bitwise in
    test_seam_dp.py — this closes the triangle native == scan == kernel on
    the shipping dtype."""
    from dct_carver_tpu.ops.carve import carve_n_seams

    luma = _structured_luma("photo", 48, 128)
    seams = 6
    vm_native = carve_native_f32(luma, seams, 8, 0.3, 0.7)
    state = carve_n_seams(jnp.asarray(luma), seams, 8, 0.3, 0.7,
                          strip_update=True, interpret=True)
    np.testing.assert_array_equal(np.asarray(state.vmap), vm_native)


def test_library_is_keyed_on_the_host(monkeypatch):
    """A checkout copied to another host builds its own library: the file
    name changes with the CPU's feature flags and the machine type."""
    import platform as host

    from dct_carver_tpu.utils import native

    here = native.library_path()
    assert here == native.library_path()  # stable on one host
    monkeypatch.setattr(native, "_cpu_flags", lambda: "sse2 other-cpu")
    other_cpu = native.library_path()
    monkeypatch.setattr(host, "machine", lambda: "aarch64")
    other_machine = native.library_path()
    assert len({here, other_cpu, other_machine}) == 3
    assert all(p.startswith(native._BUILD_DIR) for p in
               (here, other_cpu, other_machine))


def test_library_is_keyed_on_the_source(monkeypatch, tmp_path):
    from dct_carver_tpu.utils import native

    src = tmp_path / "carver.cc"
    src.write_bytes(open(native._SRC, "rb").read())
    monkeypatch.setattr(native, "_SRC", str(src))
    before = native.library_path()
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    assert native.library_path() != before
