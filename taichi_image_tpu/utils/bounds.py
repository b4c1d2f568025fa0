"""Bounds (min/max) primitives.

Reference: ``taichi_image/util.py:21-84``. The reference's ``Bounds`` is a
Taichi dataclass updated with device atomics (util.py:32-38); here bounds
are computed with pure ``jnp.min``/``jnp.max``
tree reductions and carried as a tiny (2,) f32 array or a host dataclass.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class Bounds:
  """Host-side {min, max} pair (reference util.py:21-47)."""

  min: float
  max: float

  @property
  def span(self) -> float:
    return self.max - self.min

  def union(self, other: "Bounds") -> "Bounds":
    return Bounds(min(self.min, other.min), max(self.max, other.max))

  def expand(self, v: float) -> "Bounds":
    return Bounds(min(self.min, v), max(self.max, v))

  def to_vec(self):
    return np.array([self.min, self.max], np.float32)


def union_bounds(bounds: Iterable[Bounds]) -> Bounds:
  """Reference util.py:63-69."""
  result = Bounds(np.inf, -np.inf)
  for b in bounds:
    result = result.union(b)
  return result


def bounds_to_np(b: Bounds) -> np.ndarray:
  return np.array([b.min, b.max], np.float32)


def bounds_from_np(b) -> Bounds:
  return Bounds(float(b[0]), float(b[1]))


def image_bounds(image: jnp.ndarray) -> jnp.ndarray:
  """Whole-image min/max over every element, as a (2,) f32 array.

  Functional replacement for the atomic reduction ``bounds_func``
  (reference util.py:49-60).
  """
  x = image.astype(jnp.float32)
  return jnp.stack([jnp.min(x), jnp.max(x)])


def lerp(t, a, b):
  """a + t * (b - a)  (reference util.py:82-84)."""
  return a + t * (b - a)
