"""Builds the CUDA C++ kernels under ``csrc/`` with ``nvcc`` and loads them
with ``ctypes``.

Each source ``csrc/<name>.cu`` becomes one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). Libraries are
built at first use into ``build/`` beside this file, named after a hash of
the source and of the headers ``csrc/*.cuh`` so that an edited source or
header is rebuilt. ``build_all`` starts one ``nvcc``
per source at the same time. A failed build raises with the compiler's
output; nothing here falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
KERNEL_SOURCES: Tuple[str, ...] = ("paged_attention", "flash_prefill",
                                   "flash_prefill_bwd", "ssd_scan", "ssd_scan_bwd")
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC")

_libraries: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, the ``PATH``, or /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin):"
        " the CUDA kernels of repro_torch cannot be built on this host")


def _paths(name: str) -> Tuple[Path, Path]:
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"kernel source missing: {src}")
    digest = hashlib.sha1(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest = digest.hexdigest()[:12]
    return src, BUILD_DIR / f"lib{name}_{digest}.so"


def _nvcc_command(nvcc: str, src: Path, tmp: Path,
                  extra_flags: Iterable[str]) -> List[str]:
    return [nvcc, *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(src)]


def _finish(name: str, proc: subprocess.Popen, tmp: Path, lib: Path) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for kernel {name!r} (exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)   # atomic: a reader never sees a half-written library
    return out


def build_all(names: Iterable[str] = KERNEL_SOURCES, *,
              extra_flags: Iterable[str] = ()) -> Dict[str, str]:
    """Build every library of ``names`` that is missing, all compilers
    started together. Returns each built kernel's compiler output (empty
    for a library that was already there)."""
    extra_flags = tuple(extra_flags)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    outputs: Dict[str, str] = {}
    try:
        for name in names:
            src, lib = _paths(name)
            if lib.is_file() and not extra_flags:
                outputs[name] = ""
                continue
            tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
            proc = subprocess.Popen(
                _nvcc_command(find_nvcc(), src, tmp, extra_flags),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            running.append((name, proc, tmp, lib))
        while running:
            name, proc, tmp, lib = running.pop(0)
            outputs[name] = _finish(name, proc, tmp, lib)
    finally:
        for _, proc, tmp, _ in running:   # a build failed: stop the others
            proc.kill()
            proc.communicate()
            tmp.unlink(missing_ok=True)
    return outputs


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    lib = _libraries.get(name)
    if lib is None:
        _, path = _paths(name)
        if not path.is_file():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _libraries[name] = lib
    return lib
