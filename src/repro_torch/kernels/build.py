"""Build and load the repository's CUDA sources (nvcc -> shared library ->
ctypes).

Each kernel source is compiled on first use into
``<repo>/build/kernels/lib<name>-<hash>.so`` for ``sm_90a``; the hash of
the source text and of the shared header ``common.cuh`` names the file, so
an edited source rebuilds and an unchanged one loads. ``build_all`` starts one ``nvcc`` per source at once
and waits for all of them. A failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
SOURCES: Dict[str, Path] = {
    "flash_decode": KERNELS_DIR / "flash_decode" / "csrc" / "flash_decode.cu",
    "fused_ffn": KERNELS_DIR / "fused_ffn" / "csrc" / "fused_ffn.cu",
    "gemv_int8": KERNELS_DIR / "gemv" / "csrc" / "gemv_int8.cu",
}
HEADERS = [KERNELS_DIR / "common.cuh"]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(KERNELS_DIR)]

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (CUDA_HOME unset and no nvcc on "
                       "PATH): the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    text = b"".join(p.read_bytes() for p in [SOURCES[name], *HEADERS])
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()
                          ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _nvcc_cmd(name: str, out: Path) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(SOURCES[name])]


def build_all(names=None) -> Dict[str, str]:
    """Compile every missing library concurrently (one nvcc per source).
    Returns each library's ptxas report (registers, shared memory, spills)
    for the sources built in this call."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load_library(name: str) -> ctypes.CDLL:
    """The kernel's shared library, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
