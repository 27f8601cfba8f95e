"""Native (C++) host-side components, ctypes-bound.

The compute path is JAX/XLA/Pallas; this package holds the *runtime*
pieces that stay on the host and benefit from native code — currently the
mesh loader feeding the URDF collision/visual pipeline (robot catalogs
carry 100s of MB of STL geometry; reference ``ARCHITECTURE.md:118``).

The shared library is built lazily from the bundled C++ source with the
system ``g++`` on first use and cached next to the source. Everything
here is optional: callers (``urdf/geometry.py``) fall back to the pure
Python loaders when the toolchain or the build is unavailable, mirroring
the reference's graceful-degradation contract (SURVEY.md section 5,
"every GPU entry point catches any exception and falls back").

Set ``MANIPULAPY_TPU_NO_NATIVE=1`` to disable the native path entirely.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

__all__ = ["available", "load_stl", "load_obj", "build", "library_path"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "mesh_loader.cpp")
_SO = os.path.join(_DIR, "_mesh_loader.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _disabled() -> bool:
    return os.environ.get("MANIPULAPY_TPU_NO_NATIVE", "").lower() in ("1", "true", "yes")


def library_path() -> str:
    return _SO


def build(force: bool = False) -> bool:
    """Compile the shared library with g++. Returns True on success."""
    global _build_failed
    if os.path.exists(_SO) and not force:
        return True
    with _lock:
        if os.path.exists(_SO) and not force:
            return True
        # Compile to a temp file and move into place so a concurrent
        # importer never dlopens a half-written .so.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_DIR)
        os.close(fd)
        cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, _SO)
            return True
        except (OSError, subprocess.SubprocessError):
            _build_failed = True
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if _disabled() or _build_failed:
        return None
    if not os.path.exists(_SO) and not build():
        return None
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_SO)
            for name in ("mpt_load_stl", "mpt_load_obj"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
                    ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.c_char_p,
                    ctypes.c_int,
                ]
            lib.mpt_free.restype = None
            lib.mpt_free.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


def available() -> bool:
    """True if the native loader can be used (built or buildable)."""
    return _load() is not None


def _call(fn_name: str, path: str) -> Tuple[np.ndarray, np.ndarray]:
    lib = _load()
    if lib is None:
        raise RuntimeError("native mesh loader unavailable")
    verts_p = ctypes.POINTER(ctypes.c_double)()
    faces_p = ctypes.POINTER(ctypes.c_int32)()
    n_verts = ctypes.c_int64()
    n_faces = ctypes.c_int64()
    err = ctypes.create_string_buffer(256)
    rc = getattr(lib, fn_name)(
        path.encode(), ctypes.byref(verts_p), ctypes.byref(faces_p),
        ctypes.byref(n_verts), ctypes.byref(n_faces), err, len(err),
    )
    if rc != 0:
        raise ValueError(f"{fn_name}({path!r}): {err.value.decode(errors='replace')}")
    try:
        nv, nf = n_verts.value, n_faces.value
        verts = np.ctypeslib.as_array(verts_p, shape=(nv, 3)).copy() if nv else np.zeros((0, 3))
        faces = (
            np.ctypeslib.as_array(faces_p, shape=(nf, 3)).copy().astype(np.int32)
            if nf
            else np.zeros((0, 3), dtype=np.int32)
        )
    finally:
        lib.mpt_free(verts_p)
        lib.mpt_free(faces_p)
    return verts, faces


def load_stl(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(vertices (V,3) f64, faces (F,3) i32) — welded + sorted, identical
    output contract to ``urdf.geometry._index_triangles``."""
    return _call("mpt_load_stl", path)


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(vertices, faces) preserving the OBJ file's own vertex order
    (parity with ``urdf.geometry.load_obj``: OBJ is not welded)."""
    return _call("mpt_load_obj", path)
