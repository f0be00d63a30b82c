"""Build the port's kernels from the sources in the checkout, at first use.

CUDA C++ sources under ``repro_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` into shared libraries with a plain C interface, loaded with
``ctypes``. Each library is named by a hash of its source, the headers of
``csrc/`` it includes and the flags, so an edited source or header rebuilds
and concurrent builds never see a half-written file.
Everything goes under ``build/kernels`` at the repository root, which
``.gitignore`` lists. A build failure raises with the compiler's output;
nothing falls back to a plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each library built by
# this process, by library name
PTXAS_REPORTS: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "port's CUDA kernels are built on the machine "
                           "with the card")
    return str(path)


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and the headers it includes with ``#include "..."``,
    theirs too, in the order found."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [path.parent / inc for inc in
                 re.findall(r'^\s*#\s*include\s*"([^"]+)"', path.read_text(), re.M)]
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_library(name: str, force: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless this exact source (headers
    included) was built before, or always with ``force`` (which records the
    ptxas report)."""
    out = library_path(name)
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {name} ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    PTXAS_REPORTS[name] = proc.stderr
    os.replace(tmp, out)
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_library(name)))
        _LIBS[name] = lib
    return lib
