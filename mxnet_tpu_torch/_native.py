"""ctypes binding for the native data-plane library (reference:
``python/mxnet/base.py`` loading ``libmxnet.so``; the port's copy of
``mxnet_tpu/_native.py``).

The library is the JAX package's C++ data plane, ``cxx/mxtpu_io.cc``
(RecordIO, JPEG/PNG decode, the threaded decode-augment-batch pipeline),
unchanged. The port compiles it itself, at first use, with the flags of
``cxx/Makefile`` into ``mxnet_tpu_torch/_build/`` (git-ignored), under a
name that carries a hash of the sources and the flags. It never builds or
loads ``cxx/libmxtpu.so``: that file is the JAX package's, and a stale
copy can lack symbols. A failed build raises :class:`MXNetError` with the
compiler's output; nothing falls back to a Python path.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from .base import MXNetError

_PKG = os.path.dirname(os.path.abspath(__file__))
CXX_DIR = os.path.join(os.path.dirname(_PKG), "cxx")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("mxtpu_io.cc", "mxtpu_io.h")
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread")
LDFLAGS = ("-shared", "-ljpeg", "-lpng", "-pthread")

_LIB = None
_ERROR = None
_LOCK = threading.Lock()


def _target() -> str:
    h = hashlib.sha256(" ".join(CXXFLAGS + LDFLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CXX_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmxtpu_io-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile ``cxx/mxtpu_io.cc`` into ``_build/`` unless its library is
    there; return the library's path. Processes that build at once take
    turns on a lock file, and the library is renamed into place whole."""
    out = _target()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "mxtpu_io.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out
        cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [cxx, *CXXFLAGS, os.path.join(CXX_DIR, "mxtpu_io.cc"), "-o",
               tmp, *LDFLAGS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise MXNetError(f"building the native data plane failed: "
                             f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise MXNetError(
                "building the native data plane failed (rc "
                f"{proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stderr}{proc.stdout}")
        os.replace(tmp, out)
    return out


def get_lib():
    """The loaded library, built first if need be; raises
    :class:`MXNetError` (the same error again on every later call) when
    the build or the load fails."""
    global _LIB, _ERROR
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _ERROR is not None:
            raise _ERROR
        try:
            path = build()
            lib = ctypes.CDLL(path)
        except (MXNetError, OSError) as e:
            _ERROR = e if isinstance(e, MXNetError) else MXNetError(
                f"loading the native data plane failed: {e}")
            raise _ERROR from None
        _declare(lib)
        _LIB = lib
        return lib


def _declare(lib):
    c_int, c_i64, c_u64 = ctypes.c_int, ctypes.c_int64, ctypes.c_uint64
    c_vp, c_cp = ctypes.c_void_p, ctypes.c_char_p
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(c_int)
    sig = {
        "MXTPUGetLastError": (c_cp, []),
        "MXTPURecordIOOpen": (c_int, [c_cp, c_int, ctypes.POINTER(c_vp)]),
        "MXTPURecordIOClose": (c_int, [c_vp]),
        "MXTPURecordIOReadRecord": (c_i64, [c_vp, ctypes.POINTER(u8p)]),
        "MXTPURecordIOWriteRecord": (c_int, [c_vp, u8p, c_u64]),
        "MXTPURecordIOSeek": (c_int, [c_vp, c_u64]),
        "MXTPURecordIOTell": (c_i64, [c_vp]),
        "MXTPURecordIOScanIndex": (c_i64, [c_cp, ctypes.POINTER(c_u64),
                                           c_i64]),
        "MXTPURecordIOReadAt": (c_i64, [c_vp, c_u64, ctypes.POINTER(u8p)]),
        "MXTPUImageDecode": (c_int, [u8p, c_u64, c_int, u8p, ip, ip, ip]),
        "MXTPUImageResize": (c_int, [u8p, c_int, c_int, c_int, u8p, c_int,
                                     c_int]),
        "MXTPUPipelineCreate": (c_int, [
            c_cp, c_cp, c_int, c_int, c_int, c_int, c_int, c_int, c_int,
            c_int, f32p, f32p, c_int, c_u64, ctypes.POINTER(c_vp)]),
        "MXTPUPipelineNext": (c_int, [c_vp, f32p, f32p]),
        "MXTPUPipelineReset": (c_int, [c_vp]),
        "MXTPUPipelineDestroy": (c_int, [c_vp]),
    }
    for name, (res, args) in sig.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


class NativeImagePipeline:
    """Threaded C++ RecordIO -> decode -> augment -> batch pipeline
    (reference: ``src/io/iter_image_recordio_2.cc``). Fills float32 NCHW
    batches, normalised by ``mean``/``std``, into one reused host
    buffer."""

    def __init__(self, rec_path, idx_path, batch_size, data_shape,
                 shuffle=False, num_threads=4, rand_crop=False,
                 rand_mirror=False, mean=None, std=None, label_width=1,
                 seed=0):
        lib = get_lib()
        self._lib = lib
        c, h, w = data_shape
        self._shape = (batch_size, c, h, w)
        self._label_width = label_width
        mean_arr = (ctypes.c_float * 3)(*(list(mean) if mean is not None
                                          else [0.0, 0.0, 0.0]))
        std_arr = (ctypes.c_float * 3)(*(list(std) if std is not None
                                         else [1.0, 1.0, 1.0]))
        handle = ctypes.c_void_p()
        ret = lib.MXTPUPipelineCreate(
            rec_path.encode(), idx_path.encode(), batch_size, c, h, w,
            int(shuffle), num_threads, int(rand_crop), int(rand_mirror),
            mean_arr, std_arr, label_width, seed, ctypes.byref(handle))
        if ret != 0:
            raise MXNetError(
                f"pipeline create failed: {lib.MXTPUGetLastError().decode()}")
        self._handle = handle
        self._data_buf = np.empty(self._shape, np.float32)
        self._label_buf = np.empty((batch_size, label_width), np.float32)

    def next_batch(self):
        """``(data, label, n_valid)`` in the reused buffers, or None at the
        end of the epoch."""
        f32p = ctypes.POINTER(ctypes.c_float)
        n = self._lib.MXTPUPipelineNext(
            self._handle, self._data_buf.ctypes.data_as(f32p),
            self._label_buf.ctypes.data_as(f32p))
        if n < 0:
            raise MXNetError(
                f"pipeline failed: {self._lib.MXTPUGetLastError().decode()}")
        if n == 0:
            return None
        return self._data_buf, self._label_buf, n

    def reset(self):
        self._lib.MXTPUPipelineReset(self._handle)

    def __del__(self):
        if getattr(self, "_handle", None):
            try:
                self._lib.MXTPUPipelineDestroy(self._handle)
            except Exception:  # noqa: BLE001 - interpreter teardown
                pass


def decode_image(buf: bytes, channels=3):
    """Native JPEG/PNG decode to an HWC uint8 numpy array, or None when
    the codec refuses the bytes."""
    lib = get_lib()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    raw = (ctypes.c_uint8 * len(buf)).from_buffer_copy(buf)
    if lib.MXTPUImageDecode(raw, len(buf), channels, None, ctypes.byref(w),
                            ctypes.byref(h), ctypes.byref(c)) != 0:
        return None
    out = np.empty((h.value, w.value, c.value), np.uint8)
    if lib.MXTPUImageDecode(raw, len(buf), channels, out.ctypes.data_as(u8p),
                            ctypes.byref(w), ctypes.byref(h),
                            ctypes.byref(c)) != 0:
        return None
    return out
