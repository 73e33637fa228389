"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each csrc/<name>.cu is compiled by nvcc into a shared library with a plain C
interface, under metaeuk_tpu_torch/build/ (listed in .gitignore). The library
name carries a digest of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded. Nothing is built at import.
"""

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# name -> {"path", "seconds", "ptxas"} for libraries built by this process
BUILT = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME "
                       f"({cuda_home}); the CUDA kernels cannot be built")


def build(name):
    """Path of lib<name>-<digest>.so, compiling csrc/<name>.cu if needed.
    The digest covers the source, every header of csrc/ and the flags."""
    src = CSRC_DIR / f"{name}.cu"
    headers = b"".join(h.read_bytes()
                       for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"lib{name}-{digest[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr}")
    os.replace(tmp, so)
    BUILT[name] = {"path": str(so), "seconds": time.perf_counter() - t0,
                   "ptxas": res.stderr.strip()}
    return so


@functools.lru_cache(maxsize=None)
def load(name):
    """The ctypes handle of csrc/<name>.cu, built on first call."""
    return ctypes.CDLL(str(build(name)))
