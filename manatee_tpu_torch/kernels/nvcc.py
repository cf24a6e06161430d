"""Build the port's CUDA C++ kernels with nvcc, at first use.

Each ``csrc/<name>.cu`` compiles, for Hopper (``sm_90a``), into
``build/lib<name>-<digest>.so``, a shared library with a plain C entry
point that ctypes loads.  The digest covers the source and the flags, so
an edited source is rebuilt and a stale library is never loaded.  The
compiler's report (``-Xptxas -v``: registers, shared memory, spills) is
kept beside the library as ``.log``.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# every kernel source of the port, csrc/<name>.cu
KERNELS = ("mlp_forward", "mlp_train", "synthetic_batch", "mc_array",
           "mc_dedup")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    return shutil.which("nvcc") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` as it is now lives."""
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + " ".join(FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(*names: str) -> dict[str, Path]:
    """Compile every named kernel that has no library for its current
    source yet, one nvcc process per source, all started together.
    Returns name -> library path; raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for name in names:
            lib = library_path(name)
            if lib.exists():
                continue
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            log = lib.with_suffix(".log")
            with open(log, "w") as fh:
                proc = subprocess.Popen(
                    [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                    stdout=fh, stderr=subprocess.STDOUT)
            jobs.append((name, proc, tmp, lib, log))
        failed = []
        for name, proc, tmp, lib, log in jobs:
            if proc.wait() != 0:
                failed.append("%s: nvcc exited %d\n%s"
                              % (name, proc.returncode, log.read_text()))
            else:
                # atomic: a concurrent builder of the same source loads
                # either nothing or a whole library
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    finally:
        for _name, proc, tmp, _lib, _log in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The kernel library for ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build(name)[name]))
    return lib
