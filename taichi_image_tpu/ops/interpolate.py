"""Bilinear/nearest resize and the eight axis-aligned image transforms.

Reference: ``taichi_image/interpolate.py``. The reference's dst-driven
gather (``p = dst_index / scale`` with truncation split and edge clamp,
interpolate.py:24-34,59-66) is expressed here as separable axis gathers:
the sample positions depend only on the row/col index, so the 4-tap
bilinear gather factorizes into a row interpolation followed by a column
interpolation (two `jnp.take` + lerp passes), which XLA maps onto cheap
vectorized gathers instead of per-pixel scalar addressing.

Known reference bugs consciously fixed (documented deviations):
  * ``resize_bilinear(src, size)`` without an explicit ``scale`` computes
    ``vec2(size) / vec2(src.shape[:2])`` — (w,h)/(h,w), a swapped-axes bug
    (interpolate.py:133). We compute the per-axis scale correctly; the
    ISP path (scalar scale) is unaffected and bit-matches.
  * ``transverse`` in the Taichi path indexes out of bounds for non-square
    images (interpolate.py:51-52 with transformed_size not swapping,
    interpolate.py:112-117); we implement the standard anti-transpose.
"""

from __future__ import annotations

from enum import Enum
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from taichi_image_tpu import types

__all__ = [
    "ImageTransform", "transform", "transformed_size",
    "resize_bilinear", "resize_nearest", "resize_width", "scale_bilinear",
]


class ImageTransform(Enum):
  """Reference interpolate.py:9-17."""
  none = "none"
  rotate_90 = "rotate_90"
  rotate_180 = "rotate_180"
  rotate_270 = "rotate_270"
  transpose = "transpose"
  flip_horiz = "flip_horiz"
  flip_vert = "flip_vert"
  transverse = "transverse"


def transformed_size(size, t: ImageTransform):
  """Output (a, b) under transform for input size (a, b)
  (reference interpolate.py:112-117, with transverse fixed to swap)."""
  a, b = size
  if t in (ImageTransform.rotate_90, ImageTransform.rotate_270,
           ImageTransform.transpose, ImageTransform.transverse):
    return (b, a)
  return (a, b)


def transform(src, t: ImageTransform):
  """Apply one of the eight axis-aligned transforms.

  Matches the reference gather semantics (interpolate.py:36-54):
  rotate_90 is CLOCKWISE (dst[i,j] = src[W-1-j, i]), rotate_270
  counter-clockwise. Implemented with XLA-fusable flips/transposes rather
  than a gather kernel.
  """
  x = jnp.asarray(src)
  if t == ImageTransform.none:
    return x
  if t == ImageTransform.rotate_90:       # clockwise
    return jnp.rot90(x, k=-1, axes=(0, 1))
  if t == ImageTransform.rotate_180:
    return jnp.rot90(x, k=2, axes=(0, 1))
  if t == ImageTransform.rotate_270:      # counter-clockwise
    return jnp.rot90(x, k=1, axes=(0, 1))
  if t == ImageTransform.transpose:
    return jnp.swapaxes(x, 0, 1)
  if t == ImageTransform.flip_horiz:
    return jnp.flip(x, axis=1)
  if t == ImageTransform.flip_vert:
    return jnp.flip(x, axis=0)
  if t == ImageTransform.transverse:      # anti-transpose
    return jnp.flip(jnp.swapaxes(x, 0, 1), axis=(0, 1))
  raise ValueError(f"unknown transform {t}")


def _axis_samples(n_out: int, n_in: int, scale: float):
  """Truncation-split sample positions along one axis
  (reference interpolate.py:25-27,64-66): p = i/scale, i0 = trunc(p),
  frac = p - i0, taps clamped to [0, n_in-1]."""
  p = np.arange(n_out, dtype=np.float32) / np.float32(scale)
  i0 = p.astype(np.int32)
  frac = p - i0.astype(np.float32)
  lo = np.clip(i0, 0, n_in - 1)
  hi = np.clip(i0 + 1, 0, n_in - 1)
  return lo, hi, frac


@partial(jax.jit, static_argnames=("size", "scale", "in_dtype", "out_dtype"))
def _resize_bilinear(src, size, scale, in_dtype, out_dtype):
  h_in, w_in = src.shape[:2]
  w_out, h_out = size
  sy, sx = scale
  r_lo, r_hi, r_f = _axis_samples(h_out, h_in, sy)
  c_lo, c_hi, c_f = _axis_samples(w_out, w_in, sx)

  x = src.astype(jnp.float32)
  # rows first (frac.x mixes rows in the reference, interpolate.py:28-33)
  top = jnp.take(x, jnp.asarray(r_lo), axis=0)
  bot = jnp.take(x, jnp.asarray(r_hi), axis=0)
  rows = top + jnp.asarray(r_f)[:, None, None] * (bot - top)
  left = jnp.take(rows, jnp.asarray(c_lo), axis=1)
  right = jnp.take(rows, jnp.asarray(c_hi), axis=1)
  out = left + jnp.asarray(c_f)[None, :, None] * (right - left)

  intensity_scale = types.scale_of(out_dtype) / types.scale_of(in_dtype)
  out = out * jnp.float32(intensity_scale)
  out_dt = types.canonical_dtype(out_dtype)
  if out_dt.kind in "ui":
    out = jnp.clip(out, 0, types.scale_of(out_dtype))
  return out.astype(out_dt)


@partial(jax.jit, static_argnames=("size", "scale", "in_dtype", "out_dtype"))
def _resize_nearest(src, size, scale, in_dtype, out_dtype):
  h_in, w_in = src.shape[:2]
  w_out, h_out = size
  sy, sx = scale
  r_lo, _, _ = _axis_samples(h_out, h_in, sy)
  c_lo, _, _ = _axis_samples(w_out, w_in, sx)
  out = jnp.take(jnp.take(src, jnp.asarray(r_lo), axis=0),
                 jnp.asarray(c_lo), axis=1)
  intensity_scale = types.scale_of(out_dtype) / types.scale_of(in_dtype)
  if intensity_scale != 1.0:
    out = out.astype(jnp.float32) * jnp.float32(intensity_scale)
  out_dt = types.canonical_dtype(out_dtype)
  if out_dt.kind in "ui" and intensity_scale != 1.0:
    out = jnp.clip(out, 0, types.scale_of(out_dtype))
  return out.astype(out_dt)


def _norm_scale_hw(h, w, size, scale):
  """Per-axis (scale_y, scale_x) for a resize: None derives from the
  target size; a scalar applies to both axes."""
  if scale is None:
    return (size[1] / h, size[0] / w)
  if np.ndim(scale) == 0:
    return (float(scale), float(scale))
  return (float(scale[0]), float(scale[1]))


def _norm_scale(src, size, scale):
  h, w = src.shape[:2]
  return _norm_scale_hw(h, w, size, scale)


def resize_bilinear(src, size, scale=None, dtype=None):
  """Resize to ``size=(w, h)`` with the reference's truncation-anchored
  4-tap bilinear sampling (reference interpolate.py:128-139)."""
  in_dtype = types.dtype_of(src)
  out_dtype = in_dtype if dtype is None else types.canonical_dtype(dtype)
  size = (int(size[0]), int(size[1]))
  return _resize_bilinear(jnp.asarray(src), size, _norm_scale(src, size, scale),
                          in_dtype, out_dtype)


def resize_nearest(src, size, scale=None, dtype=None):
  """Nearest-neighbor resize (a cheap mode; the reference has no
  explicit NN kernel)."""
  in_dtype = types.dtype_of(src)
  out_dtype = in_dtype if dtype is None else types.canonical_dtype(dtype)
  size = (int(size[0]), int(size[1]))
  return _resize_nearest(jnp.asarray(src), size, _norm_scale(src, size, scale),
                         in_dtype, out_dtype)


def resize_width(src, width: int, dtype=None):
  """Aspect-preserving resize to a target width
  (reference interpolate.py:141-145)."""
  h, w = src.shape[:2]
  scale = width / w
  size = (width, int(h * scale))
  return resize_bilinear(src, size, scale, dtype)


def scale_bilinear(src, scale, dtype=None):
  """Scale-factor resize (reference interpolate.py:147-151)."""
  h, w = src.shape[:2]
  size = (int(w * scale), int(h * scale))
  return resize_bilinear(src, size, scale, dtype=dtype)
