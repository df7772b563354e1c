"""Build the port's CUDA sources into one shared library, at first use.

Every ``kernels/*/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``, one
process per source, all started together, then linked into one shared
library with a plain C interface that the wrappers load with ``ctypes``.
Nothing includes PyTorch's headers, so a build takes seconds.

The library goes to ``build/kernels/<digest>/`` at the root of the
checkout (``REPRO_TORCH_BUILD_DIR`` overrides the root), where ``<digest>``
hashes the sources and flags: an edit to a source builds a new library
instead of loading a stale one.  Nothing is built or imported until a
wrapper launches a kernel, so the package imports on hosts without CUDA.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SOURCES = tuple(sorted(_PKG.glob("*/csrc/*.cu")))
HEADERS = tuple(sorted(_PKG.glob("*/csrc/*.cuh")))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None   # wall time of the build this process ran
build_log: str = ""                  # nvcc/ptxas output (registers, spills)


def build_root() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR", _PKG.parents[2] / "build" / "kernels"))


def nvcc() -> str:
    candidates = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if os.environ.get("CUDA_HOME"):
        candidates.insert(0, str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    for cand in candidates:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError(
        "nvcc not found: the kernels are CUDA C++ for sm_90a and "
        "build only where the CUDA toolkit is installed"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in SOURCES + HEADERS:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    global build_seconds, build_log
    out_dir = build_root() / _digest()
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [compiler, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        logs = [(src, p.communicate()[0], p.returncode) for src, p in zip(SOURCES, procs)]
        build_log = "\n".join(f"== {src.name}\n{out}" for src, out, _ in logs)
        failed = [src.name for src, _, rc in logs if rc != 0]
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [compiler, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)  # atomic: concurrent builders agree
    build_seconds = time.perf_counter() - t0
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib
