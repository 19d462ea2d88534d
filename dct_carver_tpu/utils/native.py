"""ctypes bindings for the native C++ reference carver (native/carver.cc).

The library is compiled on demand with g++ (no pybind11 dependency — plain
`extern "C"` + ctypes).  The native carver is the framework's CPU-side second
oracle and the BASELINE config-1 "single-core CPU reference run".

The build is `-march=native`, so the library's file name carries a hash of
the source, the machine type and the host CPU's feature flags: a checkout
copied to another host builds its own library instead of loading one made
for a different CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

__all__ = ["native_available", "energy_map_native", "carve_native",
           "energy_map_native_f32", "carve_native_f32"]

_LOCK = threading.Lock()
_LIB = None
_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_SRC = os.path.join(_REPO_ROOT, "native", "carver.cc")
_BUILD_DIR = os.path.join(_REPO_ROOT, "native", "build")
_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC"]


def _cpu_flags() -> str:
    """The host CPU's feature flags (Linux), or "" where unreadable."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return ""


def library_path() -> str:
    """Where the library for THIS host lives: keyed on the source, the
    compiler flags, the machine type and the CPU's feature flags."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    for part in (" ".join(_FLAGS), platform.machine(), _cpu_flags()):
        h.update(b"\0" + part.encode())
    return os.path.join(_BUILD_DIR, f"libdctcarver-{h.hexdigest()[:16]}.so")


def _load():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = library_path()
        if not os.path.exists(so):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            # -ffp-contract=off: the f32-chain mode must not fuse the
            # mul-add chains into FMAs, or its values diverge from the
            # exactly-rounded XLA chains it is compared against.  Build to
            # a private name and rename, so that another process never
            # loads a half-written file.
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC],
                           check=True, capture_output=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.dc_energy_map.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.dc_energy_map.restype = None
        lib.dc_carve.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ]
        lib.dc_carve.restype = ctypes.c_int
        lib.dc_energy_map_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.dc_energy_map_f32.restype = None
        lib.dc_carve_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ]
        lib.dc_carve_f32.restype = ctypes.c_int
        _LIB = lib
        return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def energy_map_native(luma: np.ndarray, blocksize: int, edges: float,
                      textures: float) -> np.ndarray:
    """luma (H, W) float64 -> (H, W) float32 energy (spec semantics)."""
    lib = _load()
    luma = np.ascontiguousarray(luma, dtype=np.float64)
    H, W = luma.shape
    out = np.empty((H, W), np.float32)
    lib.dc_energy_map(
        luma.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), H, W,
        blocksize, edges, textures,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def carve_native(luma: np.ndarray, n_seams: int, blocksize: int,
                 edges: float, textures: float,
                 tie: str = "leftmost") -> np.ndarray:
    """luma (H, W) float64 -> int32 (H, W) visibility map.  `tie` is the
    S1/S2 DP tie knob (docs/PARITY.md), applied identically to the JAX
    paths."""
    lib = _load()
    luma = np.ascontiguousarray(luma, dtype=np.float64)
    H, W = luma.shape
    vmap = np.empty((H, W), np.int32)
    rc = lib.dc_carve(
        luma.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), H, W,
        blocksize, edges, textures, n_seams,
        vmap.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        1 if tie == "rightmost" else 0,
    )
    if rc != 0:
        raise ValueError(f"dc_carve failed with code {rc}")
    return vmap


def energy_map_native_f32(luma: np.ndarray, blocksize: int, edges: float,
                          textures: float) -> np.ndarray:
    """f32-CHAIN energy: bit-equal to the JAX production path's
    `energy_from_bands` at f32 (same multiply-add order, no FMA)."""
    lib = _load()
    luma = np.ascontiguousarray(luma, dtype=np.float32)
    H, W = luma.shape
    out = np.empty((H, W), np.float32)
    lib.dc_energy_map_f32(
        luma.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), H, W,
        blocksize, edges, textures,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def carve_native_f32(luma: np.ndarray, n_seams: int, blocksize: int,
                     edges: float, textures: float,
                     tie: str = "leftmost") -> np.ndarray:
    """f32-chain carve: the independent seam oracle for the SHIPPING config
    (f32 energy + f32 DP).  luma (H, W) float32 -> int32 visibility map."""
    lib = _load()
    luma = np.ascontiguousarray(luma, dtype=np.float32)
    H, W = luma.shape
    vmap = np.empty((H, W), np.int32)
    rc = lib.dc_carve_f32(
        luma.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), H, W,
        blocksize, edges, textures, n_seams,
        vmap.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        1 if tie == "rightmost" else 0,
    )
    if rc != 0:
        raise ValueError(f"dc_carve_f32 failed with code {rc}")
    return vmap
