"""Device runtime: discovery, mesh construction, and a serialized dispatch
queue for host-threaded camera drivers.

Reference: ``taichi_image/taichi_queue.py`` (91 LoC). The Taichi runtime is
thread-affine so the reference ships a single-worker executor owning
``ti.init`` (taichi_queue.py:40-85). JAX dispatch is thread-safe, so the
queue is not *required* — but its role ("one place that owns device init
and serializes submission") survives as this module: device/mesh discovery
plus an optional ``DispatchQueue`` with the same API surface
(init/run_sync/run_async/stop, ``NullExecutor`` inline mode, context
manager) so downstream multi-threaded camera drivers can port unchanged.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import jax
import numpy as np

__all__ = [
    "devices", "device_count", "make_camera_mesh", "CAMERA_AXIS",
    "NullExecutor", "DispatchQueue", "dispatch_queue", "queued",
]

CAMERA_AXIS = "cam"


def devices(backend: Optional[str] = None):
  """All accelerator devices visible to this process."""
  return jax.devices(backend)


def device_count(backend: Optional[str] = None) -> int:
  return len(jax.devices(backend))


def make_camera_mesh(n_devices: Optional[int] = None,
                     axis_name: str = CAMERA_AXIS) -> jax.sharding.Mesh:
  """1-D mesh over the camera/batch axis — the data-parallel axis of the
  ISP (SURVEY.md §2.9: camera/frame sharding across devices)."""
  devs = jax.devices()
  if n_devices is not None:
    devs = devs[:n_devices]
  return jax.sharding.Mesh(np.array(devs), (axis_name,))


class NullExecutor:
  """Inline (non-threaded) executor (reference taichi_queue.py:9-20)."""

  def __init__(self, initializer=None, **kwargs):
    if initializer is not None:
      initializer()
    self._threads = []

  def submit(self, fn, *args, **kwargs):
    future = Future()
    future.set_result(fn(*args, **kwargs))
    return future

  def shutdown(self, wait=True):
    pass


class DispatchQueue:
  """Process-wide serialized dispatcher (reference taichi_queue.py:40-85).

  ``init(threaded=True)`` starts a single worker thread that owns the
  initializer (e.g. warmup compilation / mesh construction); ``run_sync``
  and ``run_async`` submit callables to it from any host thread. Futures
  passed as arguments are resolved before the call (taichi_queue.py:66-68).
  """

  executor = None
  _worker_ident = None  # set by the worker thread itself at init

  @classmethod
  def init(cls, initializer=None, *, threaded: bool = False):
    if cls.executor is not None:
      raise RuntimeError("DispatchQueue already initialized")
    init_fn = initializer if initializer is not None else (lambda: None)

    def _record_and_init():
      # the worker records its own ident — no reliance on the private
      # ThreadPoolExecutor._threads attribute
      cls._worker_ident = threading.get_ident()
      init_fn()

    if threaded:
      cls.executor = ThreadPoolExecutor(
          max_workers=1, thread_name_prefix="isp-dispatch",
          initializer=_record_and_init)
    else:
      cls._worker_ident = None  # inline mode: no dedicated worker
      cls.executor = NullExecutor(initializer=init_fn)
    return cls.executor

  @staticmethod
  def thread_id():
    DispatchQueue.queue()  # raises if not initialized
    return DispatchQueue._worker_ident

  @classmethod
  def queue(cls):
    if cls.executor is None:
      raise RuntimeError(
          "DispatchQueue not initialized (run DispatchQueue.init())")
    return cls.executor

  @staticmethod
  def _await_run(func, *args, **kwargs):
    args = [a.result() if isinstance(a, Future) else a for a in args]
    return func(*args, **kwargs)

  @staticmethod
  def run_async(func, *args, **kwargs) -> Future:
    return DispatchQueue.queue().submit(DispatchQueue._await_run, func,
                                        *args, **kwargs)

  @staticmethod
  def run_sync(func, *args, **kwargs):
    ident = DispatchQueue.thread_id()
    if ident is not None and threading.get_ident() == ident:
      raise RuntimeError(
          "DispatchQueue.run_sync() called from worker thread (deadlock)")
    return DispatchQueue.run_async(func, *args, **kwargs).result()

  @classmethod
  def stop(cls):
    executor = cls.executor
    if executor is not None:
      executor.shutdown(wait=True)
      cls.executor = None
      cls._worker_ident = None


class _DispatchQueueContext:
  def __init__(self, *args, **kwargs):
    self.args = args
    self.kwargs = kwargs

  def __enter__(self):
    return DispatchQueue.init(*self.args, **self.kwargs)

  def __exit__(self, exc_type, exc_value, traceback):
    DispatchQueue.stop()


def dispatch_queue(*args, **kwargs):
  """Context manager (reference taichi_queue.py:23-36)."""
  return _DispatchQueueContext(*args, **kwargs)


def queued(fn):
  """Wrap a callable so any host thread runs it through the queue
  (reference taichi_queue.py:88-91)."""
  def f(*args, **kwargs):
    return DispatchQueue.run_sync(fn, *args, **kwargs)
  return f
