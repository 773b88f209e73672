"""Build the port's CUDA sources into shared libraries and bind them.

Each ``csrc/*.cu`` file exposes a plain C interface (launch functions that
return ``cudaGetLastError()``) and is compiled by ``nvcc`` for ``sm_90a``
at first use into ``torch_robotics_tpu_torch/_build/`` (git-ignored),
then loaded with ``ctypes``.  Libraries are named by a hash of their
source and of the shared headers (``csrc/*.cuh``), so an edited source is
rebuilt and a built one is reused.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

__all__ = ["CudaKernel", "build_all", "nvcc_path", "BUILD_DIR", "CSRC_DIR"]

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


class CudaKernel:
    """One kernel of a CUDA source, with its own launch counter.

    ``functions`` maps each exported C function to its ctypes argtypes;
    every function returns an int CUDA error code.  ``launch`` calls one,
    raises on a nonzero code and only then adds one to ``launches``.
    Kernels of one source share its library (built once).
    """

    def __init__(self, source: str, functions: Dict[str, List]):
        self.source = CSRC_DIR / source
        self.functions = functions
        self.launches = 0
        self._lib = None

    @property
    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            h.update(header.read_bytes())
        digest = h.hexdigest()[:16]
        return BUILD_DIR / f"{self.source.stem}-{digest}.so"

    def start_build(self):
        """Start nvcc for this source unless the library exists; returns the
        process (or None) so several builds can run side by side.  Its
        output goes to a log beside the library."""
        out = self.library_path
        if out.is_file():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(".so.tmp%d" % os.getpid())
        log = out.with_suffix(".log.tmp%d" % os.getpid())
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        with open(log, "w") as f:
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
        proc.kernel_tmp, proc.kernel_out, proc.kernel_log = tmp, out, log
        return proc

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            build_all([self])
            lib = ctypes.CDLL(str(self.library_path))
            for name, argtypes in self.functions.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def launch(self, name: str, *args) -> None:
        err = getattr(self.lib(), name)(*args)
        if err != 0:
            raise RuntimeError("%s: CUDA launch failed with error %d"
                               % (name, err))
        self.launches += 1


def build_all(kernels: Iterable[CudaKernel],
              seconds: Optional[Dict[str, float]] = None) -> Dict[str, str]:
    """Build every missing library, all nvcc processes at once (one per
    source); returns the compiler output (register and spill report) per
    source, read from the log kept beside a library built earlier.  With
    ``seconds``, records there each source's build time (wall seconds from
    the common start to its nvcc's exit, polled every 0.1 s)."""
    by_source = {}
    for k in kernels:
        by_source.setdefault(k.source, k)
    t0 = time.perf_counter()
    procs = [(k, k.start_build()) for k in by_source.values()]
    pending = [(k, p) for k, p in procs if p is not None]
    while pending:
        for k, proc in list(pending):
            if proc.poll() is not None:
                pending.remove((k, proc))
                if seconds is not None:
                    seconds[k.source.name] = time.perf_counter() - t0
        if pending:
            time.sleep(0.1)
    logs = {}
    for k, proc in procs:
        if proc is None:
            log = k.library_path.with_suffix(".log")
            if log.is_file():
                logs[k.source.name] = log.read_text()
            continue
        out = proc.kernel_log.read_text()
        logs[k.source.name] = out
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed on %s:\n%s" % (k.source, out))
        os.replace(proc.kernel_tmp, proc.kernel_out)
        os.replace(proc.kernel_log, proc.kernel_out.with_suffix(".log"))
    return logs
