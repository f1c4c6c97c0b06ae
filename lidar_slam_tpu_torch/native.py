"""The C++ oracle pipeline, built from source for the port's checks.

``lidar_slam_tpu/native/src/slam_core.cpp`` is the clean-room C++ program
the fidelity pipeline is held to, bit for bit. The JAX package ships it
prebuilt with ``-march=native`` for the machine it was built on; this module
compiles the same source with the same flags into the port's build
directory (``_build/``) on the machine at hand and calls it through the same
plain C interface, without importing the JAX package. The library's CSV
reader is the fast dataset ingest (``read_csv``).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from lidar_slam_tpu_torch import _build

ORACLE_SRC = os.path.join(_build.PKG_DIR, "..", "lidar_slam_tpu", "native",
                          "src", "slam_core.cpp")
ORACLE_LIB = os.path.join(_build.BUILD_DIR, "libtpuslam_oracle.so")
# -ffp-contract=off keeps every multiply-add a separate rounding, as in the
# JAX package's build of the same source
GXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC",
             "-std=c++17")

_oracle: ctypes.CDLL | None = None


def load_oracle() -> ctypes.CDLL:
    global _oracle
    if _oracle is None:
        src = os.path.abspath(ORACLE_SRC)
        if _build.is_stale(ORACLE_LIB, [src]):
            _build.compile_to(lambda out: ["g++", *GXX_FLAGS, "-o", out, src],
                              ORACLE_LIB)
        lib = ctypes.CDLL(ORACLE_LIB)
        f = ctypes.POINTER(ctypes.c_float)
        lib.tpuslam_run_cfg.restype = ctypes.c_int
        lib.tpuslam_run_cfg.argtypes = [
            f, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, f, f, ctypes.c_int]
        lib.tpuslam_read_csv.restype = ctypes.c_int
        lib.tpuslam_read_csv.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                         ctypes.c_int, f]
        _oracle = lib
    return _oracle


def run_oracle_cfg(ranges: np.ndarray, cfg, use_naive_edt: bool = False
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Run the oracle with the sizes of a ``SlamConfig``; ``use_naive_edt``
    selects the library's brute-force EDT over its separable one. Returns
    (path (T, 3) f32, map (M, 2) f32)."""
    lib = load_oracle()
    ranges = np.ascontiguousarray(ranges, np.float32)
    t, n_beams = ranges.shape
    cap = cfg.map.map_capacity
    path = np.zeros((t, 3), np.float32)
    omap = np.zeros((cap, 2), np.float32)
    fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    msize = lib.tpuslam_run_cfg(fp(ranges), t, n_beams, int(use_naive_edt),
                                ctypes.c_float(cfg.lidar.usable_range),
                                cfg.grid.coarse_size, cfg.grid.fine_size, cap,
                                fp(path), fp(omap), cap)
    return path, omap[:msize]


def read_csv(path: str, n_rows: int, n_cols: int = 1079) -> np.ndarray:
    """Parse up to ``n_rows`` rows of ``n_cols`` comma-separated floats with
    the oracle library's reader (``tpuslam_read_csv``); (rows read, n_cols)
    f32. Raises ``FileNotFoundError`` when the file cannot be opened."""
    lib = load_oracle()
    out = np.zeros((n_rows, n_cols), np.float32)
    got = lib.tpuslam_read_csv(os.fsencode(path), n_rows, n_cols,
                               out.ctypes.data_as(
                                   ctypes.POINTER(ctypes.c_float)))
    if got < 0:
        raise FileNotFoundError(path)
    return out[:got]
