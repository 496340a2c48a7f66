"""ctypes bindings for the native C++ real-time runtime (native/rt_runtime.cc).

The compute path is JAX/XLA on the accelerator; this native layer is the host runtime the
reference implemented with Python multiprocessing + shared memory (the
MPC_Wrapper one-solve-stale handoff) and what a real-robot deployment needs for
the hard 1 kHz loop (SURVEY.md §2.2, §3.2).  Built on demand with g++ (this
image has no pybind11; ctypes keeps the binding dependency-free)."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "..", "native", "rt_runtime.cc")
_SO = os.path.join(_HERE, "_rt_runtime.so")
_LOCK = threading.Lock()
_LIB = None


def ensure_built() -> ctypes.CDLL:
    """Compile (if needed) and load the native library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        src = os.path.abspath(_SRC)
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(src)):
            subprocess.run(
                ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                 "-o", _SO, src, "-lpthread"],
                check=True, capture_output=True)
        lib = ctypes.CDLL(_SO)
        lib.plan_buffer_create.restype = ctypes.c_void_p
        lib.plan_buffer_create.argtypes = [ctypes.c_int]
        lib.plan_buffer_destroy.argtypes = [ctypes.c_void_p]
        lib.plan_buffer_publish.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.plan_buffer_read.restype = ctypes.c_int64
        lib.plan_buffer_read.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        lib.rt_executor_create.restype = ctypes.c_void_p
        lib.rt_executor_create.argtypes = [ctypes.c_int64]
        lib.rt_executor_destroy.argtypes = [ctypes.c_void_p]
        lib.rt_executor_run.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_int64),
            ctypes.c_void_p]
        lib.rt_executor_ticks.restype = ctypes.c_int64
        lib.rt_executor_ticks.argtypes = [ctypes.c_void_p]
        lib.rt_executor_overruns.restype = ctypes.c_int64
        lib.rt_executor_overruns.argtypes = [ctypes.c_void_p]
        lib.rt_executor_max_jitter_us.restype = ctypes.c_double
        lib.rt_executor_max_jitter_us.argtypes = [ctypes.c_void_p]
        lib.rt_executor_mean_jitter_us.restype = ctypes.c_double
        lib.rt_executor_mean_jitter_us.argtypes = [ctypes.c_void_p]
        lib.telemetry_ring_create.restype = ctypes.c_void_p
        lib.telemetry_ring_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.telemetry_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.telemetry_ring_push.restype = ctypes.c_int
        lib.telemetry_ring_push.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        lib.telemetry_ring_pop.restype = ctypes.c_int
        lib.telemetry_ring_pop.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        lib.telemetry_ring_dropped.restype = ctypes.c_int64
        lib.telemetry_ring_dropped.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


class PlanBuffer:
    """Wait-free SPSC double buffer with one-solve-stale read semantics."""

    def __init__(self, n: int):
        self._lib = ensure_built()
        self._n = n
        self._h = ctypes.c_void_p(self._lib.plan_buffer_create(n))

    def publish(self, plan: np.ndarray, plan_id: int) -> None:
        arr = np.ascontiguousarray(plan, dtype=np.float32).reshape(-1)
        assert arr.size == self._n
        self._lib.plan_buffer_publish(
            self._h, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            plan_id)

    def read_latest(self) -> tuple[int, np.ndarray]:
        out = np.empty(self._n, np.float32)
        pid = self._lib.plan_buffer_read(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return int(pid), out

    def __del__(self):
        try:
            self._lib.plan_buffer_destroy(self._h)
        except Exception:
            pass


class TelemetryRing:
    """Wait-free SPSC ring of fixed-size float records (native-backed).

    The 1 kHz control loop `push`es one record per tick — no allocation,
    locks, or syscalls, and NEVER blocks (a full ring drops the record and
    counts it).  A logger thread `pop`s batches.  Host analog of the
    reference's preallocated-array logger (SURVEY.md §5.5)."""

    def __init__(self, record_len: int, capacity: int = 4096):
        self._lib = ensure_built()
        self._len = record_len
        self._h = ctypes.c_void_p(
            self._lib.telemetry_ring_create(record_len, capacity))

    def push(self, record: np.ndarray) -> bool:
        arr = np.ascontiguousarray(record, dtype=np.float32).reshape(-1)
        assert arr.size == self._len
        return bool(self._lib.telemetry_ring_push(
            self._h, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))))

    def pop(self, max_records: int = 1024) -> np.ndarray:
        """Drain up to max_records; returns an (n, record_len) array."""
        out = np.empty((max_records, self._len), np.float32)
        n = self._lib.telemetry_ring_pop(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            max_records)
        return out[:n]

    @property
    def dropped(self) -> int:
        return int(self._lib.telemetry_ring_dropped(self._h))

    def __del__(self):
        try:
            self._lib.telemetry_ring_destroy(self._h)
        except Exception:
            pass


class RtExecutor:
    """Fixed-period executor with absolute deadlines + jitter stats."""

    _CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_int64)

    def __init__(self, period_s: float):
        self._lib = ensure_built()
        self._h = ctypes.c_void_p(
            self._lib.rt_executor_create(int(period_s * 1e9)))

    def run(self, ticks: int, callback) -> None:
        """callback(tick_index) is invoked at each period boundary."""
        cb = self._CB(lambda _user, k: callback(int(k)))
        self._lib.rt_executor_run(self._h, ticks, cb, None)

    @property
    def stats(self) -> dict:
        return {
            "ticks": int(self._lib.rt_executor_ticks(self._h)),
            "overruns": int(self._lib.rt_executor_overruns(self._h)),
            "max_jitter_us": float(
                self._lib.rt_executor_max_jitter_us(self._h)),
            "mean_jitter_us": float(
                self._lib.rt_executor_mean_jitter_us(self._h)),
        }

    def __del__(self):
        try:
            self._lib.rt_executor_destroy(self._h)
        except Exception:
            pass
