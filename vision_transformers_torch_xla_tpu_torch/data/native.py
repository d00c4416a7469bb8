"""ctypes binding to the native IO runtime (native/vtx_io.cpp).

Counterpart of vision_transformers_torch_xla_tpu/data/native.py for the
decode entry points (`jpeg_dims` :84, `decode_jpeg_crop_resize` :96), the
synthetic batch (`synth_batch` :115) and the threaded decode pool
(`DecodePool` :129), over the same native/libvtx_io.so. `available()` is
False when the library is missing or does not load (for instance without
libjpeg); callers then decode another way, as the JAX callers do, and
`DecodePool` raises.
"""
from __future__ import annotations

import ctypes
import logging
import os
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

_LIB_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                         "libvtx_io.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = os.path.abspath(_LIB_PATH)
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        log.warning("failed to load %s: %s", path, e)
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.vtx_decode_jpeg_crop_resize.restype = ctypes.c_int
    lib.vtx_decode_jpeg_crop_resize.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, f32p, f32p, f32p]
    lib.vtx_jpeg_dims.restype = ctypes.c_int
    lib.vtx_jpeg_dims.argtypes = [u8p, ctypes.c_int64,
                                  ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int)]
    lib.vtx_synth_batch.restype = None
    lib.vtx_synth_batch.argtypes = [
        f32p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint64, f32p, f32p]
    lib.vtx_pool_create.restype = ctypes.c_void_p
    lib.vtx_pool_create.argtypes = [ctypes.c_int, f32p, f32p]
    lib.vtx_pool_submit.restype = None
    lib.vtx_pool_submit.argtypes = [
        ctypes.c_void_p, u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int64]
    lib.vtx_pool_take_failed.restype = ctypes.c_int64
    lib.vtx_pool_take_failed.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
    lib.vtx_pool_wait.restype = None
    lib.vtx_pool_wait.argtypes = [ctypes.c_void_p]
    lib.vtx_pool_destroy.restype = None
    lib.vtx_pool_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _f3(vals) -> "ctypes.Array":
    return (ctypes.c_float * 3)(*[float(v) for v in vals])


def jpeg_dims(data: bytes) -> Tuple[int, int]:
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.vtx_jpeg_dims(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                           len(data), ctypes.byref(w), ctypes.byref(h))
    if rc:
        raise ValueError("not a decodable JPEG")
    return w.value, h.value


def decode_jpeg_crop_resize(data: bytes, out_size: int,
                            crop: Optional[Tuple[int, int, int, int]] = None,
                            mean=(0.485, 0.456, 0.406),
                            std=(0.229, 0.224, 0.225)) -> np.ndarray:
    """Fused decode -> crop(x, y, w, h) -> resize(out_size) -> normalize."""
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((out_size, out_size, 3), np.float32)
    cx, cy, cw, ch = crop if crop is not None else (-1, -1, -1, -1)
    stdinv = [1.0 / s for s in std]
    rc = lib.vtx_decode_jpeg_crop_resize(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
        cx, cy, cw, ch, out_size, _f3(mean), _f3(stdinv),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc:
        raise ValueError("JPEG decode failed")
    return out


def synth_batch(batch: int, size: int, num_classes: int, seed: int,
                mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)):
    """Native synthetic batch: (images f32 NHWC, labels i32)."""
    lib = _load()
    images = np.empty((batch, size, size, 3), np.float32)
    labels = np.empty((batch,), np.int32)
    stdinv = [1.0 / s for s in std]
    lib.vtx_synth_batch(
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        batch, size, num_classes, seed, _f3(mean), _f3(stdinv))
    return images, labels


class DecodePool:
    """Threaded decode pool: submit JPEG -> tensor jobs, wait for a batch.

    Each job decodes, crops, resizes and normalizes one JPEG into its own
    float32 (out_size, out_size, 3) slot of a caller's array, on a C++
    worker thread; `wait` returns when every submitted job is done."""

    def __init__(self, num_threads: int = 0,
                 mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library not built (make -C native)")
        self._lib = lib
        n = num_threads or max(os.cpu_count() or 1, 1)
        stdinv = [1.0 / s for s in std]
        self._pool = lib.vtx_pool_create(n, _f3(mean), _f3(stdinv))
        # the encoded bytes of the jobs in flight, alive until `wait`
        self._keepalive = []

    def submit(self, data: bytes, dst: np.ndarray, out_size: int,
               crop: Optional[Tuple[int, int, int, int]] = None,
               tag: int = -1):
        """Queue one decode of `data` into `dst`, a C-contiguous float32
        (out_size, out_size, 3) array that stays alive until `wait`."""
        if (dst.dtype != np.float32 or not dst.flags.c_contiguous
                or dst.shape != (out_size, out_size, 3)):
            raise ValueError(f"dst must be a C-contiguous float32 "
                             f"({out_size}, {out_size}, 3) array, got "
                             f"{dst.dtype} {dst.shape}")
        buf = np.frombuffer(data, np.uint8)
        self._keepalive.append(buf)
        cx, cy, cw, ch = crop if crop is not None else (-1, -1, -1, -1)
        self._lib.vtx_pool_submit(
            self._pool, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(data), cx, cy, cw, ch, out_size,
            dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), tag)

    def wait(self):
        self._lib.vtx_pool_wait(self._pool)
        self._keepalive.clear()

    def take_failed(self, cap: int = 4096) -> list:
        """Tags of the jobs whose decode failed since the last call (the
        worker zero-filled their slots)."""
        out = (ctypes.c_int64 * cap)()
        n = self._lib.vtx_pool_take_failed(self._pool, out, cap)
        return [out[i] for i in range(n)]

    def close(self):
        if self._pool:
            self._lib.vtx_pool_destroy(self._pool)
            self._pool = None

    def __del__(self):
        # a pool dropped without close(): nothing to report from here
        if getattr(self, "_pool", None):
            self.close()
