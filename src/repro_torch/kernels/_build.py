"""Build and load the port's CUDA kernels (route: nvcc + ctypes).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with
``nvcc`` for ``sm_90a`` into a shared library under ``kernels/_build/``
(git-ignored), named by the hash of its source, so an edited source is
rebuilt and an unchanged one is loaded as it is.  Nothing is compiled when
a module is imported: the first CUDA launch calls :func:`load`, which
builds every source of ``csrc/`` at once (one ``nvcc`` each, started
together).  ``ptxas`` reports each kernel's registers, shared memory and
spills into ``_build/<name>.log``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); the "
                       "CUDA kernels are built on the machine with the card")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that has no up-to-date library, all
    ``nvcc`` processes running together; raises with the compiler's output
    if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {name: library_path(name) for name in names}
    procs = {}
    for name, lib in out.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{name}.log", "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT), log, tmp)
    failed = []
    for name, (proc, log, tmp) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out[name])   # atomic: concurrent builders agree
        else:
            failed.append(name)
    if failed:
        details = "\n".join((BUILD_DIR / f"{n}.log").read_text()
                            for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{details}")
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``; the first call builds
    every source that has no up-to-date library."""
    return ctypes.CDLL(str(build(SOURCES)[name]))
