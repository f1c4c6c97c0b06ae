"""Build and load the hand-written CUDA kernels (``csrc/*.cu``) and the
conditional-node capture that ``utils/graphs.cond`` and
``utils/graphs.while_loop`` call.

Each source compiles with its own ``nvcc``, all started together, and the
objects link into one shared library with a plain C interface, loaded with
``ctypes``. The build happens at first use, into
``_build/`` beside this file (listed in ``.gitignore``), and again whenever a
source is newer than the library. Nothing is compiled at import.

Flags: ``sm_90a`` (Hopper), ``--fmad=false`` so no multiply-add is
contracted into an FMA (the trig32 and 2^-10 lattice exactness depend on
separate roundings), and never ``--use_fast_math`` (it would replace IEEE
division and square root with approximations).
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
KERNEL_LIB = os.path.join(BUILD_DIR, "libslam_kernels.so")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC")

_kernels: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_PP = ctypes.POINTER(ctypes.c_void_p)   # a C array of pointers
_PF = ctypes.POINTER(ctypes.c_float)    # a C array of floats
# name -> argtypes of every exported launcher; each returns cudaError_t
_SIGNATURES = {
    # occ u8 (B,H,W), out f32 (B,H,W), B, H, W, R, band rows, stream
    "slam_edt_clamped": (_P, _P, _I, _I, _I, _I, _I, _P),
    # metric f32 (B,S,S), S, cx0 i32 (B,T,N), cy0 i32 (B,T,N), valid u8
    # (B,N), B, T, N, n_rows i32*, n_cols i32*, half, lattice bits q,
    # beams per block, tile codes, scores f32 (B,T,W,W), stream
    "slam_corr_volume": (_P, _I, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I,
                         _I, _I, _P, _P),
    # metric f32 (S,S), S, n_rows i32*, n_cols i32*, origin f32 (2),
    # 1/pixel, x f32 (N), y f32 (N), valid u8 (N), N, pose f32 (3),
    # step_t, step_r, window_t, window_r, penalty, pose f32 (3), score
    # f32*, best count i32*, last hits f32 (N), last mask u8 (N), stream
    "slam_scan_match": (_P, _I, _P, _P, _P, _F, _P, _P, _P, _I, _P, _F, _F,
                        _I, _I, _F, _P, _P, _P, _P, _P, _P),
    # per cascade level (arrays, finest first): scores, counts f32
    # (B,T,W,W), base f32 (B,3), 1/pixel, theta step; levels, T, W, half;
    # poses f32 (n,3), n, poses a volume row, dist f32 (n), escape u8 (n)
    # or null, stream
    "slam_vol_lookup": (_PP, _PP, _PP, _PF, _PF, _I, _I, _I, _I, _P, _I, _I,
                        _P, _P, _P),
    # the same cascade (B = 1); est f32 (3), offs f32 (k,3), k, out f32
    # (3), stream
    "slam_vol_refine": (_PP, _PP, _PP, _PF, _PF, _I, _I, _I, _I, _P, _P, _I,
                        _P, _P),
    # ranges f32 (N), angles f32 (N), N, range_min, usable_range, x f32
    # (N), y f32 (N), valid u8 (N), size i32*, stream
    "slam_scan_intake": (_P, _P, _I, _F, _F, _P, _P, _P, _P, _P),
    # graph_cond.cu: capture stream, child stream, pred bool*; child stream
    "slam_if_begin": (_P, _P, _P),
    "slam_if_end": (_P,),
    # ... and the handle's address (out); child stream, handle, pred bool*
    "slam_while_begin": (_P, _P, _P, ctypes.POINTER(ctypes.c_ulonglong)),
    "slam_while_end": (_P, ctypes.c_ulonglong, _P),
}


def kernel_sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def kernel_headers() -> list[str]:
    """``csrc/*.cuh``: included by the sources, so a newer one rebuilds."""
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(a CUDA toolkit is needed on the machine with "
                           "the card)")
    return nvcc


def nvcc_compile_command(nvcc: str, source: str, obj: str) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-c", "-o", obj, source]


def nvcc_command(nvcc: str, inputs: list[str], out: str) -> list[str]:
    """The command that builds the shared library from ``inputs`` (the
    compiled objects, or the sources themselves)."""
    return [nvcc, *NVCC_FLAGS, "-shared", "-o", out, *inputs]


def is_stale(lib: str, sources: list[str]) -> bool:
    if not os.path.exists(lib):
        return True
    t = os.path.getmtime(lib)
    return any(os.path.getmtime(s) > t for s in sources)


def compile_to(cmd_for, out: str) -> None:
    """Run ``cmd_for(tmp_path)`` and move the result to ``out`` atomically,
    so concurrent first uses never load a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(cmd_for(tmp), capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"build failed ({' '.join(cmd_for(tmp))}):\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def build_kernels(force: bool = False) -> str:
    """Compile ``csrc/*.cu`` into ``_build/libslam_kernels.so`` if needed."""
    sources = kernel_sources()
    if not (force or is_stale(KERNEL_LIB, sources + kernel_headers())):
        return KERNEL_LIB
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o")
                for s in sources]
        procs = []
        try:
            for src, obj in zip(sources, objs):
                procs.append(subprocess.Popen(
                    nvcc_compile_command(nvcc, src, obj),
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True))
            failed = []
            for src, proc in zip(sources, procs):
                out, err = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"{src}:\n{out}\n{err}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if failed:
            raise RuntimeError("build failed:\n" + "\n".join(failed))
        compile_to(lambda out: nvcc_command(nvcc, objs, out), KERNEL_LIB)
    return KERNEL_LIB


def load_kernels() -> ctypes.CDLL:
    """The kernel library, built on first use, with every launcher's
    ``argtypes`` declared (pointers as ``c_void_p``, never truncated)."""
    global _kernels
    if _kernels is None:
        lib = ctypes.CDLL(build_kernels())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _kernels = lib
    return _kernels


def check(err: int, name: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")
