"""Build and load the CUDA kernels (csrc/*.cu).

Each kernel source compiles with nvcc into its own shared library with a
plain C interface, loaded with ctypes. The library is keyed on a hash of
the sources and the flags and lands in plz4_tpu_torch/_build/ through a
tmp file and os.replace, so concurrent builds never load a partial file
(the same scheme as native/__init__.py). A missing nvcc or a failed build
raises: nothing falls back to the plain versions or to the CPU.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
# kernel library -> {C entry point: (device pointers, ints)}; every entry
# point also takes the CUDA stream last and returns a cudaError_t
KERNELS = {
    "lz4_encode": {"lz4t_launch": (6, 3)},            # K2a
    "lz4_decode": {"lz4t_launch": (5, 3)},            # K1
    "lz4_encode_window": {"lz4t_launch": (8, 6)},     # K2b
    "lz4_encode_mid": {"lz4t_launch": (9, 7)},        # K2c, K2d
    "lz4_encode_deep": {"lz4t_launch": (9, 8),        # K4
                        "lz4t_launch_plain": (6, 5)},
    "lz4_decode_window": {"lz4t_launch_dict": (6, 5),  # K3
                          "lz4t_launch_records": (8, 4)},  # K5 (and K6c)
    "lz4_encode_wide": {"lz4t_launch": (6, 5)},       # K6b
    "lz4_decode_wide": {"lz4t_launch": (5, 3)},       # K6a
    "xxh32": {"lz4t_launch": (3, 3)},                 # K7
}
# host build of the row bodies (csrc/lz4_host.cpp): entry point -> (pointers,
# ints); the CPU tests call these
HOST_FNS = {
    "lz4t_host_encode": (5, 3),
    "lz4t_host_encode_window": (7, 6),
    "lz4t_host_encode_mid": (7, 7),
    "lz4t_host_encode_deep": (7, 8),
    "lz4t_host_encode_deep_plain": (5, 5),
    "lz4t_host_deep_chain": (5, 6),
    "lz4t_host_decode": (5, 3),
    "lz4t_host_decode_dict": (6, 5),
    "lz4t_host_decode_records": (6, 4),
    "lz4t_host_encode_wide": (6, 5),
    "lz4t_host_decode_wide": (5, 3),
    "lz4t_host_xxh32": (3, 3),
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _headers() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def _so_path(name: str) -> str:
    h = hashlib.sha256()
    for p in [os.path.join(CSRC, name + ".cu")] + _headers():
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one kernel source unless its library is built.
    Returns (so_path, tmp_path, Popen) or None."""
    so = _so_path(name)
    if os.path.exists(so):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    return so, tmp, proc


def _finish(job) -> None:
    so, tmp, proc = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {os.path.basename(so)}:\n"
            f"{out.decode(errors='replace')}")
    os.replace(tmp, so)


def build_all() -> None:
    """Build every kernel library, one nvcc per source, all at once."""
    with _lock:
        jobs = [j for j in map(_start, KERNELS) if j is not None]
        errors = []
        for job in jobs:
            try:
                _finish(job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library `name`, built at first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            job = _start(name)
            if job is not None:
                _finish(job)
            lib = ctypes.CDLL(_so_path(name))
            for fn, (n_ptr, n_int) in KERNELS[name].items():
                f = getattr(lib, fn)
                f.restype = ctypes.c_int
                f.argtypes = ([ctypes.c_void_p] * n_ptr
                              + [ctypes.c_int] * n_int + [ctypes.c_void_p])
            lib.lz4t_error_string.restype = ctypes.c_char_p
            lib.lz4t_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
    return _libs[name]


def load_host() -> ctypes.CDLL:
    """g++ build of the kernels' row bodies (csrc/lz4_host.cpp): the CPU
    tests run the kernels' own logic through it where there is no GPU.
    The package itself never calls it."""
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC"]
    src = os.path.join(CSRC, "lz4_host.cpp")
    h = hashlib.sha256(" ".join(cmd).encode())
    for p in [src] + _headers():
        with open(p, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"liblz4_host-{h.hexdigest()[:16]}.so")
    with _lock:
        if "host" not in _libs:
            if not os.path.exists(so):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{so}.tmp{os.getpid()}"
                subprocess.run([*cmd, "-o", tmp, src], check=True,
                               capture_output=True)
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
            for fn, (n_ptr, n_int) in HOST_FNS.items():
                f = getattr(lib, fn)
                f.restype = None
                f.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
            _libs["host"] = lib
    return _libs["host"]


def launch(name: str, ptrs, ints, stream: int,
           fn: str = "lz4t_launch") -> None:
    """Call entry point `fn` of kernel library `name`; raise on a non-zero
    cudaError_t (a refused launch never runs, and a later synchronize
    would not report it)."""
    lib = load(name)
    rc = getattr(lib, fn)(*ptrs, *ints, stream)
    if rc != 0:
        msg = lib.lz4t_error_string(rc)
        raise RuntimeError(
            f"{name}.{fn} launch failed: cudaError {rc} "
            f"({msg.decode(errors='replace')})")
