"""ctypes bindings of the host box kernels, with an explicit route per call.

Counterpart of ``cobevt_tpu/utils/native_ops.py``.  ``csrc/box_ops.cpp`` (the
port's copy of the JAX package's ``native/box_ops.cpp``) compiles with
``g++`` at first use into ``cobevt_tpu_torch/_build/``, under a name that
carries a hash of the source and the flags, and is loaded with ``ctypes``.
The numpy functions of ``geometry/boxes.py`` are the plain route.

Every entry takes ``route``: "native" (the default) or "numpy".  There is
no fallback: "native" raises, with ``build_error()``, when the library does
not build, and "numpy" runs only where a caller asks for it.  ``route_calls``
counts each entry's calls by the route that ran.

The two routes of ``nms_rotated`` differ as in the JAX package: the numpy
route keeps only the ``top`` = 1000 best-scored candidates, the native route
takes all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from cobevt_tpu_torch.geometry import boxes as np_boxes

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "box_ops.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
# no contraction into FMAs, so the native products round as numpy's do; no
# OpenMP (the H100 host's g++ ships no libgomp): the source's ``omp``
# pragmas are ignored, and each output element is computed as before
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off")
ROUTES = ("native", "numpy")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None

# calls of each entry by the route that ran, never reset: a caller reads the
# difference over its own span
route_calls = {name: {route: 0 for route in ROUTES}
               for name in ("bbox_overlaps", "bbox_intersections",
                            "rotated_iou", "nms_rotated")}


def library_path() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libbox_ops-{digest.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    """Compile the source into ``path`` (through a file of this process, so
    processes building at once never load a half-written library)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cxx = os.environ.get("CXX", "g++")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed for {SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None when it does not
    build."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
        except Exception as err:          # kept for build_error()
            _build_error = f"{type(err).__name__}: {err}"
            return None
        f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.bbox_overlaps.argtypes = [f32, ctypes.c_int64, f32,
                                      ctypes.c_int64, f32]
        lib.bbox_overlaps.restype = None
        lib.bbox_intersections.argtypes = lib.bbox_overlaps.argtypes
        lib.bbox_intersections.restype = None
        lib.rotated_iou.argtypes = [f64, ctypes.c_int64, f64,
                                    ctypes.c_int64, f64]
        lib.rotated_iou.restype = None
        lib.nms_rotated.argtypes = [f64, f64, ctypes.c_int64,
                                    ctypes.c_double, i64]
        lib.nms_rotated.restype = ctypes.c_int64
        _lib = lib
        return _lib


def build_error() -> Optional[str]:
    """Why the library did not build or load (None: it did, or no call has
    tried yet)."""
    return _build_error


def _rows(x, dtype, tail, what: str) -> np.ndarray:
    """``x`` as a C-contiguous (N, *tail) array of ``dtype`` (checked before
    a pointer to it is handed to the library)."""
    a = np.ascontiguousarray(x, dtype)
    if a.size == 0:
        return a.reshape((0,) + tail)
    if a.shape[1:] != tail or a.ndim != 1 + len(tail):
        raise ValueError(f"{what}: shape {a.shape}, want (N, "
                         f"{', '.join(map(str, tail))})")
    return a


def _route(name: str, route: str):
    """(route, library or None for "numpy"), counted."""
    if route not in ROUTES:
        raise ValueError(f"{name}: route {route!r}, want one of {ROUTES}")
    lib = get_lib() if route == "native" else None
    if route == "native" and lib is None:
        raise RuntimeError(f"{name}: the native route was asked for and "
                           f"the library did not build: {_build_error}")
    route_calls[name][route] += 1
    return route, lib


def bbox_overlaps(boxes, query_boxes, route: str = "native"):
    b = _rows(boxes, np.float32, (4,), "bbox_overlaps boxes")
    q = _rows(query_boxes, np.float32, (4,), "bbox_overlaps query_boxes")
    ran, lib = _route("bbox_overlaps", route)
    if ran == "numpy":
        return np_boxes.bbox_overlaps(b, q)
    out = np.zeros((len(b), len(q)), np.float32)
    lib.bbox_overlaps(b, len(b), q, len(q), out)
    return out


def bbox_intersections(boxes, query_boxes, route: str = "native"):
    b = _rows(boxes, np.float32, (4,), "bbox_intersections boxes")
    q = _rows(query_boxes, np.float32, (4,),
              "bbox_intersections query_boxes")
    ran, lib = _route("bbox_intersections", route)
    if ran == "numpy":
        return np_boxes.bbox_intersections(b, q)
    out = np.zeros((len(b), len(q)), np.float32)
    lib.bbox_intersections(b, len(b), q, len(q), out)
    return out


def rotated_iou(corners_a, corners_b, route: str = "native"):
    a = _rows(corners_a, np.float64, (4, 2), "rotated_iou corners_a")
    b = _rows(corners_b, np.float64, (4, 2), "rotated_iou corners_b")
    ran, lib = _route("rotated_iou", route)
    if ran == "numpy":
        return np_boxes.rotated_iou(a, b)
    out = np.zeros((len(a), len(b)), np.float64)
    lib.rotated_iou(a, len(a), b, len(b), out)
    return out


def nms_rotated(corners, scores, threshold: float,
                route: str = "native"):
    """Kept indices (int32) by descending score; see the module docstring
    for how the routes differ past 1000 candidates."""
    c = _rows(corners, np.float64, (4, 2), "nms_rotated corners")
    s = np.ascontiguousarray(scores, np.float64).reshape(-1)
    if len(s) != len(c):
        raise ValueError(f"nms_rotated: {len(c)} boxes, {len(s)} scores")
    ran, lib = _route("nms_rotated", route)
    if ran == "numpy" or len(c) == 0:
        return np_boxes.nms_rotated(c, s, threshold)
    keep = np.zeros(len(c), np.int64)
    kept = lib.nms_rotated(c, s, len(c), float(threshold), keep)
    return keep[:kept].astype(np.int32)
