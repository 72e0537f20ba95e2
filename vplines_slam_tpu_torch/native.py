"""ctypes bindings of the framework-free C++ host runtime
(``native/libvplines_native.so``, built from ``native/*.cc`` by
``make -C native``): ``MeasurementSync``, the ring-buffered IMU / frame
alignment with boundary-sample interpolation.

The port's own copy of ``vplines_slam_tpu/native.py``'s synchronizer
binding: it reuses the C++ runtime rather than porting it.  Without the
library (or where it does not load) ``available()`` is False and
``VioEngine`` buffers IMU in Python lists, as the reference does.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native",
    "libvplines_native.so")

_lib = None


def load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    dp = ctypes.POINTER(ctypes.c_double)
    lib.vpl_sync_create.restype = ctypes.c_void_p
    lib.vpl_sync_create.argtypes = [ctypes.c_int]
    lib.vpl_sync_destroy.argtypes = [ctypes.c_void_p]
    lib.vpl_sync_set_td.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.vpl_sync_push_imu.argtypes = [ctypes.c_void_p, ctypes.c_double, dp, dp]
    lib.vpl_sync_push_imu.restype = ctypes.c_int
    lib.vpl_sync_drain_frame_partial.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_int, ctypes.c_int, dp, dp, dp]
    lib.vpl_sync_drain_frame_partial.restype = ctypes.c_int
    _lib = lib
    return lib


def available():
    return load() is not None


def _as_dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class MeasurementSync:
    """Native IMU / frame synchronizer (needs the library: ``available()``)."""

    def __init__(self, capacity=4096):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError(f"{_LIB_PATH} is missing or does not load; "
                               "build it with `make -C native`")
        self.capacity = capacity
        self._h = self._lib.vpl_sync_create(capacity)

    def __del__(self):
        if getattr(self, "_lib", None) and getattr(self, "_h", None):
            self._lib.vpl_sync_destroy(self._h)
            self._h = None

    def set_td(self, td):
        """The camera-IMU time offset: drain_frame cuts at frame_t + td."""
        self._lib.vpl_sync_set_td(self._h, float(td))

    def push_imu(self, t, acc, gyr):
        acc = np.ascontiguousarray(acc, np.float64)
        gyr = np.ascontiguousarray(gyr, np.float64)
        return self._lib.vpl_sync_push_imu(self._h, float(t), _as_dp(acc), _as_dp(gyr))

    def drain_frame(self, frame_t, max_out=1024, allow_partial=False):
        """All IMU samples in (previous frame, frame_t + td], the boundary
        sample interpolated; allow_partial clamps the boundary to the newest
        sample when IMU lags.  Returns (t [n], acc [n, 3], gyr [n, 3]), or
        None when IMU has not caught up (and not allow_partial)."""
        t = np.empty(max_out, np.float64)
        acc = np.empty((max_out, 3), np.float64)
        gyr = np.empty((max_out, 3), np.float64)
        n = self._lib.vpl_sync_drain_frame_partial(
            self._h, float(frame_t), int(allow_partial), max_out, _as_dp(t), _as_dp(acc),
            _as_dp(gyr))
        if n < 0:
            return None
        return t[:n], acc[:n], gyr[:n]
