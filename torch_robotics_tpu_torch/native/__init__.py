"""Native (C++) host components, loaded with ctypes (counterpart of
torch_robotics_tpu/native/__init__.py).

``kdtree.cpp`` is built with ``g++ -O3 -shared -fPIC`` at first use into
``torch_robotics_tpu_torch/_build/`` (git-ignored), named by a hash of its
source as ``ops/cuda_build.py`` names the CUDA libraries, so an edited
source is rebuilt and a built one is reused.  There is no numpy fallback: a
machine without g++, or a failed build, raises RuntimeError with the
compiler's message.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["KdTree", "kdtree_library", "BUILD_DIR"]

_SRC = Path(__file__).resolve().parent / "kdtree.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_LIBS = {}


def _library_path(build_dir: Path) -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return build_dir / f"kdtree-{digest}.so"


def _build(out: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the kd-tree of RRT-Connect "
                           "is built from %s at first use" % _SRC)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(".so.tmp%d" % os.getpid())
    proc = subprocess.run([gxx, "-O3", "-shared", "-fPIC", "-o", str(tmp),
                           str(_SRC)], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise RuntimeError("g++ failed on %s:\n%s%s"
                           % (_SRC, proc.stdout, proc.stderr))
    os.replace(tmp, out)


def kdtree_library() -> ctypes.CDLL:
    """The built kd-tree library (built on first call), with its argtypes
    set."""
    path = _library_path(Path(BUILD_DIR))
    lib = _LIBS.get(path)
    if lib is not None:
        return lib
    if not path.is_file():
        _build(path)
    lib = ctypes.CDLL(str(path))
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.kd_create.restype = ctypes.c_void_p
    lib.kd_create.argtypes = [ctypes.c_int]
    lib.kd_destroy.argtypes = [ctypes.c_void_p]
    lib.kd_insert.restype = ctypes.c_int
    lib.kd_insert.argtypes = [ctypes.c_void_p, f32]
    lib.kd_nearest.restype = ctypes.c_int
    lib.kd_nearest.argtypes = [ctypes.c_void_p, f32]
    lib.kd_size.restype = ctypes.c_int
    lib.kd_size.argtypes = [ctypes.c_void_p]
    lib.kd_get_point.argtypes = [ctypes.c_void_p, ctypes.c_int, f32]
    _LIBS[path] = lib
    return lib


class KdTree:
    """Incremental nearest-neighbour structure over float32 points of
    ``dim`` coordinates (the native kd-tree; indices in insertion order)."""

    def __init__(self, dim: int):
        self.dim = dim
        self._lib = kdtree_library()
        self._handle = self._lib.kd_create(dim)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.kd_destroy(self._handle)
            self._handle = None

    def insert(self, point) -> int:
        p = np.ascontiguousarray(point, np.float32).reshape(self.dim)
        return int(self._lib.kd_insert(self._handle, p))

    def nearest(self, query) -> int:
        q = np.ascontiguousarray(query, np.float32).reshape(self.dim)
        return int(self._lib.kd_nearest(self._handle, q))

    def get_point(self, i: int) -> np.ndarray:
        out = np.empty(self.dim, np.float32)
        self._lib.kd_get_point(self._handle, int(i), out)
        return out

    def __len__(self) -> int:
        return int(self._lib.kd_size(self._handle))
