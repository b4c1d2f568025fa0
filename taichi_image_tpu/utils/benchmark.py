"""Benchmark harness.

Reference: ``taichi_image/bench/util.py:8-48``. Same shape — a context
manager timing a block, and a warmup+iterations driver — but device
synchronization is ``jax.block_until_ready`` on the last result instead of
``torch.cuda.synchronize``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import jax


def _sync(x=None):
  if x is not None:
    jax.block_until_ready(x)
  else:
    # Fence pending work with a trivial transfer. This orders only against
    # the single default device — for sharded/multi-device work, pass the
    # benchmarked outputs so every participating device is fenced (the
    # `benchmark()` driver below does).
    jax.device_get(jax.numpy.zeros(()))


class Benchmark:
  """Timing context manager (reference bench/util.py:8-28)."""

  def __init__(self, name: str, iterations: int = 1):
    self.iterations = iterations
    self.name = name
    self.elapsed = 0.0

  def __enter__(self):
    _sync()
    self.start = time.perf_counter()
    return self

  def __exit__(self, exc_type, value, traceback):
    _sync()
    self.elapsed = time.perf_counter() - self.start
    if self.iterations > 1:
      print(f"{self.name}: {self.elapsed:.4f}s "
            f"{self.iterations / self.elapsed:.2f} it/s")
    else:
      print(f"{self.name}: {self.elapsed:.4f}s")


def benchmark(name: str,
              func: Callable,
              args: Optional[List] = None,
              kwargs: Optional[Dict] = None,
              iterations: int = 1,
              warmup: int = 0,
              progress=None) -> float:
  """Warmup + timed iterations (reference bench/util.py:31-48).

  Returns iterations/second. The result of each call is block_until_ready'd
  so async dispatch does not hide the device time.
  """
  args = args or []
  kwargs = kwargs or {}
  if progress is None:
    progress = lambda x: x

  def fence(out):
    jax.block_until_ready(out)

  out = None
  for _ in progress(range(warmup)):
    out = func(*args, **kwargs)
  if out is not None:
    fence(out)

  with Benchmark(name, iterations) as b:
    for _ in progress(range(iterations)):
      out = func(*args, **kwargs)
    if out is not None:
      fence(out)
  return iterations / b.elapsed
