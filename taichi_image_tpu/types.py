"""Dtype conventions and array interop for the ISP framework.

Mirrors the role of the reference's ``taichi_image/types.py`` (reference
``types.py:12-91``): a *normalized intensity convention* where every kernel
works internally in float32 in [0, 1] and integer dtypes are related to the
normalized range by a per-dtype full-scale factor.

Differences from the reference:
  * dtypes are plain numpy/jax dtypes (no Taichi types); ``bfloat16`` is a
    first-class working dtype beside float16.
  * arrays in and out are numpy or jax arrays; torch (or any other
    producer) interoperates through DLPack instead of a hardwired torch
    branch — see :func:`from_torch` / :func:`to_torch` below. The
    reference's np/torch polymorphic ``empty_like`` (types.py:59-91) is
    unnecessary because ops are pure functions returning new arrays.
"""

from __future__ import annotations

from typing import Any, Union

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "scale_factor",
    "canonical_dtype",
    "dtype_of",
    "is_float_dtype",
    "scale_of",
    "u8",
    "u16",
    "i16",
    "f16",
    "bf16",
    "f32",
    "store_as",
    "from_dlpack",
    "to_dlpack",
    "to_torch",
    "from_torch",
]

# Short aliases, mirroring ti.u8 / ti.u16 / ti.i16 / ti.f16 / ti.f32
# (reference types.py:36-42), plus bfloat16.
u8 = np.dtype(np.uint8)
u16 = np.dtype(np.uint16)
i16 = np.dtype(np.int16)
f16 = np.dtype(np.float16)
bf16 = np.dtype(jnp.bfloat16)
f32 = np.dtype(np.float32)

DTypeLike = Union[str, type, np.dtype, Any]

# Full-scale value per dtype: the normalization contract every op follows
# (reference types.py:12-18). Values are converted to f32 in [0, 1] by
# dividing by the scale, and rescaled/cast on output.
scale_factor = {
    u8: 255.0,
    u16: 65535.0,
    i16: 32767.0,
    f16: 1.0,
    bf16: 1.0,
    f32: 1.0,
}

_names = {
    "uint8": u8,
    "uint16": u16,
    "int16": i16,
    "float16": f16,
    "bfloat16": bf16,
    "float32": f32,
}


def canonical_dtype(dtype: DTypeLike) -> np.dtype:
  """Normalize a dtype token (string / np / jnp dtype) to a np.dtype.

  Raises for dtypes outside the supported set {u8, u16, i16, f16, bf16, f32}
  (reference type_to_ti, types.py:36-42).
  """
  dt = np.dtype(dtype)
  name = dt.name
  if name not in _names:
    raise ValueError(
        f"Unsupported dtype {name}; supported: {sorted(_names)}")
  return _names[name]


def dtype_of(arr) -> np.dtype:
  """Infer the canonical dtype of a numpy or jax array.

  Mirrors ``ti_type`` (reference types.py:51-57) without the torch branch.
  """
  return canonical_dtype(arr.dtype)


def store_as(x, dtype):
  """``x`` rounded to and stored as ``dtype``: ``x.astype(dtype)`` with
  the rounding made explicit for the 16-bit floats. XLA may drop a
  narrowing convert whose result is widened again inside one fusion
  (excess precision, which the GPU backend allows by default), and the
  pipeline would then skip the working-dtype rounding it defines.
  ``reduce_precision`` is kept; it flushes f16 subnormals (< 6.1e-5) to
  zero, below the u8 and metering resolution."""
  dt = canonical_dtype(dtype)
  if dt in (f16, bf16):
    fi = jnp.finfo(dt)
    x = jax.lax.reduce_precision(jnp.asarray(x, jnp.float32),
                                 exponent_bits=fi.nexp,
                                 mantissa_bits=fi.nmant)
  return x.astype(dt)


def is_float_dtype(dtype: DTypeLike) -> bool:
  return canonical_dtype(dtype) in (f16, bf16, f32)


def scale_of(dtype: DTypeLike) -> float:
  """Full-scale value for a dtype (reference scale_factor, types.py:12-18)."""
  return scale_factor[canonical_dtype(dtype)]


def to_float(x: jnp.ndarray, compute_dtype=jnp.float32) -> jnp.ndarray:
  """Convert an array to normalized float in [0, 1] per the scale convention."""
  s = scale_of(dtype_of(x))
  x = x.astype(compute_dtype)
  if s != 1.0:
    x = x / jnp.asarray(s, compute_dtype)
  return x


def from_float(x: jnp.ndarray, dtype: DTypeLike, clip: bool = True) -> jnp.ndarray:
  """Rescale a normalized float array to ``dtype``.

  Integer casts truncate toward zero, matching Taichi's C-style float->int
  cast used throughout the reference (e.g. bayer.py:134). ``clip`` guards
  against out-of-range wraparound which the reference leaves as UB.
  """
  dt = canonical_dtype(dtype)
  s = scale_of(dt)
  if s != 1.0:
    x = x * jnp.asarray(s, x.dtype)
  if clip and not is_float_dtype(dt):
    x = jnp.clip(x, 0, s)
  return x.astype(dt)


def empty_like(in_arr, shape=None, dtype=None):
  """Allocate an uninitialized numpy array like ``in_arr``
  (reference types.py:70-78; numpy-only — ops are pure functions that
  allocate their own outputs, this exists for API compatibility)."""
  shape = in_arr.shape if shape is None else shape
  dt = dtype_of(in_arr) if dtype is None else canonical_dtype(dtype)
  return np.empty(shape, dt)


def zeros_like(in_arr, shape=None, dtype=None):
  """Reference types.py:81-91 (numpy-only)."""
  shape = in_arr.shape if shape is None else shape
  dt = dtype_of(in_arr) if dtype is None else canonical_dtype(dtype)
  return np.zeros(shape, dt)


# --------------------------------------------------------------------------
# DLPack interop.
#
# The reference borrows torch tensors zero-copy throughout (types.py:29-49,
# camera_isp.py:83-84) so camera drivers hand over GPU buffers without a
# copy. The equivalent here is the DLPack protocol: any producer
# (torch, cupy, numpy>=1.23) exchanges buffers with jax without going
# through host numpy. On CPU the exchange is zero-copy; across devices jax
# falls back to a device transfer.
# --------------------------------------------------------------------------


def from_dlpack(x) -> jnp.ndarray:
  """Import any DLPack-capable array (e.g. a torch tensor) as a jax array.

  Zero-copy when producer and consumer share the device. Accepts either
  an object implementing ``__dlpack__`` or a legacy DLPack capsule
  (torch<=1.x ``to_dlpack`` output).
  """
  import jax
  if hasattr(x, "__dlpack__"):
    return jnp.from_dlpack(x)
  return jax.dlpack.from_dlpack(x)  # legacy capsule


def to_dlpack(x):
  """Export a jax array through DLPack (consumable by
  ``torch.from_dlpack`` / ``torch.utils.dlpack.from_dlpack``).

  Returns the jax array itself — jax arrays implement ``__dlpack__`` — so
  ``torch.from_dlpack(to_dlpack(x))`` borrows the buffer zero-copy on a
  shared device.
  """
  return jnp.asarray(x)


def to_torch(x):
  """Borrow a jax array as a torch tensor via DLPack (zero-copy on a
  shared device). Requires torch."""
  import torch
  return torch.from_dlpack(jnp.asarray(x))


def from_torch(x) -> jnp.ndarray:
  """Borrow a torch tensor as a jax array via DLPack (restores the
  reference's torch ergonomics, types.py:29-49)."""
  return from_dlpack(x)
