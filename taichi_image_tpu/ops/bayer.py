"""Bayer mosaic / demosaic (Malvar-He-Cutler and bilinear).

Reference: ``taichi_image/bayer.py``. The reference demosaics with four
13-tap 5x5 diamond stencils (one per 2x2 Bayer phase, each producing a vec3
pixel, bayer.py:30-55,137-155), renormalizing dropped out-of-bounds taps at
image borders per channel (bayer.py:145-151), with an optional fused 3x3
color-correction matrix (bayer.py:127-130,152-153).

Phase-plane formulation
-----------------------
Instead of a scalar gather loop per pixel, the CFA is split into its four
half-resolution phase planes; every full-resolution 5x5 diamond tap then
lands on one phase plane at an offset in {-1,0,1}, so the whole demosaic is
a single dense 3x3 convolution with 4 input channels (phases) and 12 output
channels (4 output phases x RGB), which XLA maps onto one fused
convolution pass. Border renormalization is exact: interior tap-weight sums
are the constant 16 per channel, and the four one-pixel border strips of
the half-res grid divide by precomputed edge sums (equivalent to the
reference's drop-and-renormalize, since zero padding drops exactly the
out-of-image taps).
"""

from __future__ import annotations

import enum
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from taichi_image_tpu import types
from taichi_image_tpu.ops.kernel import symmetrical, zip_tuple
from taichi_image_tpu.utils.cache import cache

__all__ = [
    "BayerPattern", "pixel_orders", "kernel_patterns",
    "diamond_kernel", "make_bayer_kernels", "make_bilinear_kernels",
    "scale_kernel", "bayer_kernels", "bilinear_kernels",
    "rgb_to_bayer", "bayer_to_rgb", "bayer_to_rgb_batch",
]


def diamond_kernel(weights):
  """13 diamond-shaped (offset, weight) taps over a 5x5 support
  (reference bayer.py:15-27). Offsets are (row, col)."""
  diamond = [
      (0, 1),
      (-1, 2),
      (-2, 3),
      (-1, 2),
      (0, 1),
  ]
  offsets = [(i - 2, x) for i, r in enumerate(diamond) for x in range(*r)]
  assert len(offsets) == len(weights), (
      f"incorrect weight length {len(offsets)} != {len(weights)}")
  return tuple(zip(offsets, weights))


def make_bayer_kernels():
  """Four per-phase vec3 Malvar-He-Cutler weight tables, integer weights
  summing to 16 per channel (reference bayer.py:30-55)."""
  g_rb, r_g1, r_g2, rb_br, ident = [
      symmetrical(w) for w in [
          [(-2,), (0, 4), (-2, 4, 8)],   # G at R,B locations
          [(-2,), (-2, 8), (1, 0, 10)],  # R at G1 and B at G2
          [(1,), (-2, 0), (-2, 8, 10)],  # B at G1 and R at G2
          [(-3,), (4, 0), (-3, 0, 12)],  # R at B and B at R
          [(0,), (0, 0), (0, 0, 16)],    # Identity
      ]
  ]
  b_g1 = r_g2
  b_g2 = r_g1
  vec_weights = [
      zip_tuple(ident, g_rb, rb_br),  # R phase
      zip_tuple(r_g1, ident, b_g1),   # G1 phase
      zip_tuple(r_g2, ident, b_g2),   # G2 phase
      zip_tuple(rb_br, g_rb, ident),  # B phase
  ]
  return tuple(diamond_kernel(w) for w in vec_weights)


def make_bilinear_kernels():
  """Four per-phase vec3 bilinear weight tables on the same 13-tap diamond
  support (cheap demosaic mode; no reference in-repo counterpart — the
  reference compares against an external bilinear implementation,
  test/compare_bayer.py:34)."""
  ident = symmetrical([(0,), (0, 0), (0, 0, 4)])
  cross = symmetrical([(0,), (0, 1), (0, 1, 0)])          # 4-neighbor cross
  vert = symmetrical([(0,), (0, 2), (0, 0, 0)])           # up/down pair
  horiz = symmetrical([(0,), (0, 0), (0, 2, 0)])          # left/right pair
  diag = symmetrical([(0,), (1, 0), (0, 0, 0)])           # 4 diagonals
  vec_weights = [
      zip_tuple(ident, cross, diag),  # R phase
      zip_tuple(vert, ident, horiz),  # phase with R above/below
      zip_tuple(horiz, ident, vert),  # phase with R left/right
      zip_tuple(diag, cross, ident),  # B phase
  ]
  return tuple(diamond_kernel(w) for w in vec_weights)


def scale_kernel(kernel, scale):
  """Scale a kernel's vec3 weights, preserving offsets
  (reference bayer.py:57-68)."""
  return tuple(
      (offset, tuple(w * s for w, s in zip(weight, scale)))
      for offset, weight in kernel)


bayer_kernels = make_bayer_kernels()
bilinear_kernels = make_bilinear_kernels()


class BayerPattern(enum.Enum):
  """CFA layout of the top-left 2x2 quad (reference bayer.py:75-83)."""
  RGGB = 0
  GRBG = 1
  GBRG = 2
  BGGR = 3

  @property
  def pixel_order(self):
    return pixel_orders[self]


# pattern -> which RGB channel each 2x2 position samples, in the order
# (even,even), (even,odd), (odd,even), (odd,odd) of (row, col)
# (reference bayer.py:85-90; the reference's mosaic loop assigns p1..p4 in
# this order, bayer.py:106-112).
pixel_orders = {
    BayerPattern.RGGB: (0, 1, 1, 2),
    BayerPattern.GRBG: (1, 0, 2, 1),
    BayerPattern.GBRG: (1, 2, 0, 1),
    BayerPattern.BGGR: (2, 1, 1, 0),
}

# pattern -> permutation of the 4 phase kernels, in the order
# (even,even), (odd,even), (even,odd), (odd,odd) of (row, col)
# (the reference's demosaic loop applies kernels[0..3] at those positions,
# bayer.py:162-175; reference table bayer.py:92-97).
kernel_patterns = {
    BayerPattern.RGGB: (0, 1, 2, 3),
    BayerPattern.GBRG: (1, 0, 3, 2),
    BayerPattern.GRBG: (2, 3, 0, 1),
    BayerPattern.BGGR: (3, 2, 1, 0),
}

# Order in which output phases are laid out in the 12-channel conv output:
# index p -> (row parity, col parity); matches the kernel application order
# above.
_PHASE_PARITY = ((0, 0), (1, 0), (0, 1), (1, 1))


def _phase_conv_weights(kernels) -> np.ndarray:
  """Decompose four full-res 13-tap diamond vec3 kernels into a dense
  (12, 4, 3, 3) phase-plane convolution weight tensor.

  Out channel = out_phase * 3 + rgb. In channel = input phase index with
  parity order (0,0), (0,1), (1,0), (1,1) (row-major parities).
  """
  w = np.zeros((12, 4, 3, 3), np.float32)
  for p, (dy, dx) in enumerate(_PHASE_PARITY):
    for (oy, ox), weight in kernels[p]:
      sy, sx = dy + oy, dx + ox
      in_phase = (sy % 2) * 2 + (sx % 2)
      u, v = sy // 2, sx // 2  # floor division: in {-1, 0, 1}
      for c in range(3):
        w[p * 3 + c, in_phase, u + 1, v + 1] += weight[c]
  return w


def _edge_sums(w: np.ndarray, hh: int, wh: int):
  """Per-channel surviving-weight sums for the four border strips of the
  half-res grid (exact equivalent of reference bayer.py:145-151).

  Returns (interior (12,), top (12, wh), bottom (12, wh), left (12, hh),
  right (12, hh)) float32 arrays. Assumes hh >= 2 and wh >= 2.
  """
  ws = w.sum(axis=1)  # (12, 3, 3): total weight per (out_ch, u+1, v+1)

  def rsum(rows, cols):
    return ws[:, rows, :][:, :, cols].sum(axis=(1, 2))  # (12,)

  full = rsum([0, 1, 2], [0, 1, 2])
  t_mid = rsum([1, 2], [0, 1, 2])    # top row: u=-1 dropped
  b_mid = rsum([0, 1], [0, 1, 2])
  l_mid = rsum([0, 1, 2], [1, 2])
  r_mid = rsum([0, 1, 2], [0, 1])
  tl = rsum([1, 2], [1, 2])
  tr = rsum([1, 2], [0, 1])
  bl = rsum([0, 1], [1, 2])
  br = rsum([0, 1], [0, 1])

  top = np.tile(t_mid[:, None], (1, wh))
  top[:, 0], top[:, -1] = tl, tr
  bottom = np.tile(b_mid[:, None], (1, wh))
  bottom[:, 0], bottom[:, -1] = bl, br
  left = np.tile(l_mid[:, None], (1, hh))
  left[:, 0], left[:, -1] = tl, bl
  right = np.tile(r_mid[:, None], (1, hh))
  right[:, 0], right[:, -1] = tr, br
  return full, top, bottom, left, right


@cache
def _demosaic_tables(pattern: BayerPattern, method: str):
  base = bayer_kernels if method == "mhc" else bilinear_kernels
  kernels = tuple(base[i] for i in kernel_patterns[pattern])
  return _phase_conv_weights(kernels)


@cache
def _interleave_table():
  """One-hot (3, 12, 2, 2) kernel assembling full-res planar RGB from the
  12-channel phase output via a stride-2 transposed convolution."""
  k = np.zeros((3, 12, 2, 2), np.float32)
  for p, (dy, dx) in enumerate(_PHASE_PARITY):
    for c in range(3):
      k[c, p * 3 + c, 1 - dy, 1 - dx] = 1.0
  return k


# ---------------------------------------------------------------------------
# Planar phase-plane pipeline.
#
# The pipeline keeps images PLANAR end to end:
#   CFA phase planes (N, 4, H/2, W/2) -> demosaic -> (N, 12, H/2, W/2)
#   (4 output phases x RGB) -> tonemap in phase form -> planar u8.
# Interleaved HWC exists only at API boundaries.
# ---------------------------------------------------------------------------


def subsample_hw(x, sr: int, sc: int):
  """``x[..., ::sr, ::sc]`` with identical values, via free minor-dim
  reshapes when the dims divide (a windowed copy), else a strided
  slice."""
  h, w = x.shape[-2], x.shape[-1]
  if sr <= 0 or sc <= 0 or h % sr or w % sc:
    return x[..., ::sr, ::sc]
  r = x.reshape(*x.shape[:-2], h // sr, sr, w // sc, sc)
  return r[..., 0, :, 0]


def cfa_phases(cfa):
  """(N, H, W) CFA -> (N, 4, H/2, W/2) phase planes, in-phase order
  (row%2)*2 + col%2.

  Column parity splits via a free minor-dim-2 reshape; row parity is a
  stride-2 slice."""
  n, h, w = cfa.shape
  b = cfa.reshape(n, h, w // 2, 2)
  even, odd = b[..., 0], b[..., 1]
  return jnp.stack([even[:, 0::2], odd[:, 0::2],
                    even[:, 1::2], odd[:, 1::2]], axis=1)


def edge_renorm_factor(weights, hh, wh, is_top=True, is_bot=True):
  """Elementwise border-renormalization factor (1, 12, hh, wh-broadcast).

  An outer product of per-row and per-column factor vectors with the four
  corner pixels corrected via iota masks — the drop-tap divisor strips
  are separable everywhere except the corners, where the correction makes
  the combined factor EXACTLY full/corner regardless of the row/column
  vector values (so narrow images, wh == 2, stay exact). One fusable
  multiply instead of `.at[...]` dynamic-update-slices, which
  materialize full-buffer copies.

  ``is_top``/``is_bot`` may be Python bools or traced scalars (spatial
  sharding passes axis_index-derived gates so row strips fire only at the
  GLOBAL image edges).
  """
  full, top, bottom, left, right = _edge_sums(weights, hh, wh)
  t_mid, b_mid = top[:, 1], bottom[:, 1]
  l_mid, r_mid = left[:, 1], right[:, 1]
  tl, tr_ = top[:, 0], top[:, -1]
  bl, br = bottom[:, 0], bottom[:, -1]

  r_i = jax.lax.broadcasted_iota(jnp.int32, (1, 1, hh, wh), 2)
  c_i = jax.lax.broadcasted_iota(jnp.int32, (1, 1, hh, wh), 3)
  on_top = is_top & (r_i == 0)
  on_bot = is_bot & (r_i == hh - 1)

  ch = lambda v: jnp.asarray(v, jnp.float32)[None, :, None, None]
  rvf = (jnp.where(on_top, ch(full / t_mid), 1.0)
         * jnp.where(on_bot, ch(full / b_mid), 1.0))
  cv = np.ones((12, wh), np.float32)
  cv[:, 0] = full / l_mid
  cv[:, -1] = full / r_mid
  f = rvf * jnp.asarray(cv, jnp.float32)[None, :, None, :]

  # corner corrections: combined factor becomes exactly full/corner
  for corner, rvec, rmask, cpos in (
      (tl, full / t_mid, on_top, 0), (tr_, full / t_mid, on_top, wh - 1),
      (bl, full / b_mid, on_bot, 0), (br, full / b_mid, on_bot, wh - 1)):
    cval = (full / corner) / (rvec * cv[:, cpos])
    f = jnp.where(rmask & (c_i == cpos), f * ch(cval), f)
  return f


def _edge_renorm(x, weights, hh, wh):
  """Apply exact drop-tap border renormalization to interior-normalized
  (num/full) phase output."""
  return x * edge_renorm_factor(weights, hh, wh)


def demosaic_phases(phases, pattern: BayerPattern, cc=None, method="mhc",
                    out_dtype=jnp.float32, sample_step: int = 0):
  """Demosaic normalized phase planes (N, 4, hh, wh) float -> clamped
  (N, 12, hh, wh) phase-RGB in [0, 1].

  Same math as the reference stencil (bayer.py:137-155) with exact border
  renormalization; the 12-channel layout is out_phase*3 + rgb with phases
  ordered (0,0), (1,0), (0,1), (1,1) in (row, col) parity. The stencil is
  one 4 -> 12 channel 3x3 convolution at f32 ``HIGHEST`` precision.

  ``sample_step`` > 0: additionally return
  ``out[:, 0:3, ::step, ::step]`` (the metering sample grid) as
  ``(out, sample)``.
  """
  n, _, hh, wh = phases.shape
  weights = _demosaic_tables(pattern, method)
  num = jax.lax.conv_general_dilated(
      phases.astype(jnp.float32), jnp.asarray(weights), (1, 1),
      ((1, 1), (1, 1)), dimension_numbers=("NCHW", "OIHW", "NCHW"),
      precision=jax.lax.Precision.HIGHEST,
      preferred_element_type=jnp.float32)
  if hh >= 2 and wh >= 2:
    full = weights.sum(axis=(1, 2, 3))
    num16 = num * jnp.asarray(1.0 / full, jnp.float32)[None, :, None, None]
    out = _edge_renorm(num16, weights, hh, wh)
  else:
    ones = jnp.ones((1, 4, hh, wh), jnp.float32)
    denom = jax.lax.conv_general_dilated(
        ones, jnp.asarray(weights), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=jax.lax.Precision.HIGHEST)
    out = num / denom
  if cc is not None:
    ccm = jnp.asarray(np.array(cc, np.float32).reshape(3, 3))
    x = out.reshape(n, 4, 3, hh, wh)
    x = jnp.einsum("npchw,dc->npdhw", x, ccm,
                   precision=jax.lax.Precision.HIGHEST)
    out = x.reshape(n, 12, hh, wh)
  out = types.store_as(jnp.clip(out, 0.0, 1.0), out_dtype)
  if not sample_step:
    return out
  return out, subsample_hw(out[:, 0:3], sample_step, sample_step)


@cache
def _interleave_table_1ch():
  """One-hot (1, 4, 2, 2) kernel assembling a full-res plane from four
  phase planes (single-channel variant of :func:`_interleave_table`)."""
  k = np.zeros((1, 4, 2, 2), np.float32)
  for p, (dy, dx) in enumerate(_PHASE_PARITY):
    k[0, p, 1 - dy, 1 - dx] = 1.0
  return k


def phases_to_plane(x4, dtype=None):
  """(N, 4, hh, wh) single-channel phases -> full-res (N, H, W) plane.

  One 6-d transpose moving the (row, col) parity dims into interleaving
  positions; the final reshape is a free C-order merge. Exact (pure data
  movement, no dtype roundtrip)."""
  n, _, hh, wh = x4.shape
  x = x4.reshape(n, 2, 2, hh, wh)        # (n, pc, pr, hh, wh)
  t = x.transpose(0, 3, 2, 4, 1)         # (n, hh, pr, wh, pc)
  return t.reshape(n, 2 * hh, 2 * wh).astype(dtype or x4.dtype)


def phases_to_planar(x12, dtype=None):
  """(N, 12, hh, wh) phase-RGB -> full-res planar (N, 3, H, W) via a
  single 6-d transpose (exact; see :func:`phases_to_plane`)."""
  n, _, hh, wh = x12.shape
  x = x12.reshape(n, 2, 2, 3, hh, wh)    # (n, pc, pr, c, hh, wh)
  t = x.transpose(0, 3, 4, 2, 5, 1)      # (n, c, hh, pr, wh, pc)
  return t.reshape(n, 3, 2 * hh, 2 * wh).astype(dtype or x12.dtype)


def phases_to_planar_stack(x12, dtype=None):
  """(N, 12, hh, wh) phase-RGB -> full-res planar (N, 3, H, W) via two
  minor-dim-2 STACK interleaves (lane interleave as
  ``stack(..., axis=-1).reshape``, sublane as ``axis=-2`` — the
  windowed-copy pattern :func:`subsample_hw` exploits in reverse).

  Bitwise-equal to :func:`phases_to_planar`; the banded drivers'
  finish programs use this form."""
  n, _, hh, wh = x12.shape
  x = x12.reshape(n, 2, 2, 3, hh, wh)    # (n, pc, pr, c, hh, wh)

  def cols(pr):
    return jnp.stack([x[:, 0, pr], x[:, 1, pr]], axis=-1).reshape(
        n, 3, hh, 2 * wh)

  out = jnp.stack([cols(0), cols(1)], axis=-2).reshape(
      n, 3, 2 * hh, 2 * wh)
  return out.astype(dtype or x12.dtype)


def planar_to_phases(planar):
  """(N, 3, H, W) planar -> (N, 12, hh, wh) phase-RGB (inverse of
  :func:`phases_to_planar`)."""
  n, _, h, w = planar.shape
  parts = []
  for dy, dx in _PHASE_PARITY:
    parts.append(planar[:, :, dy::2, dx::2])
  return jnp.concatenate(parts, axis=1)


@partial(jax.jit, static_argnames=(
    "pattern", "correct_colors", "in_dtype", "out_dtype", "method"))
def _bayer_to_rgb(cfa, pattern, correct_colors, in_dtype, out_dtype, method):
  """Demosaic a batch of CFA images (N, H, W) -> (N, H, W, 3) via the
  planar phase-plane core (demosaic_phases), assembling interleaved HWC
  only at the end."""
  n, h, w = cfa.shape
  in_scale = types.scale_of(in_dtype)
  phases = cfa_phases(cfa).astype(jnp.float32)
  if in_scale != 1.0:
    phases = phases / jnp.float32(in_scale)
  x12 = demosaic_phases(phases, pattern, cc=correct_colors, method=method,
                        out_dtype=jnp.float32)
  planar = phases_to_planar(x12, jnp.float32)
  rgb = planar.transpose(0, 2, 3, 1)
  return types.from_float(rgb, out_dtype)


def bayer_to_rgb(bayer,
                 pattern: BayerPattern = BayerPattern.RGGB,
                 correct_colors: Optional[np.ndarray] = None,
                 dtype=None,
                 method: str = "mhc"):
  """Demosaic a 2-D CFA image to (H, W, 3) RGB.

  Matches reference ``bayer_to_rgb`` (bayer.py:202-219): Malvar-He-Cutler
  13-tap stencils, border renormalization, optional fused 3x3 color
  correction (row-major 3x3 applied as ``cc @ rgb``), clamp to [0,1] and
  rescale/cast to ``dtype`` (defaults to the input dtype). ``method`` may
  be "mhc" (reference parity) or "bilinear" (cheap mode).
  """
  if bayer.ndim != 2:
    raise ValueError(f"image must be mono bayer, got shape {bayer.shape}")
  if bayer.shape[0] % 2 or bayer.shape[1] % 2:
    raise ValueError(f"image must be even size, got {bayer.shape}")
  in_dtype = types.dtype_of(bayer)
  out_dtype = in_dtype if dtype is None else types.canonical_dtype(dtype)
  cc = None
  if correct_colors is not None:
    cc = tuple(np.asarray(correct_colors, np.float32).flatten().tolist())
  out = _bayer_to_rgb(jnp.asarray(bayer)[None], pattern, cc, in_dtype,
                      out_dtype, method)
  return out[0]


def bayer_to_rgb_batch(bayer,
                       pattern: BayerPattern = BayerPattern.RGGB,
                       correct_colors=None,
                       dtype=None,
                       method: str = "mhc"):
  """Batched demosaic: (N, H, W) -> (N, H, W, 3). Extension used by the
  fused multi-camera ISP step."""
  if bayer.ndim != 3:
    raise ValueError(
        f"expected batch of mono bayer images, got shape {bayer.shape}")
  in_dtype = types.dtype_of(bayer)
  out_dtype = in_dtype if dtype is None else types.canonical_dtype(dtype)
  cc = None
  if correct_colors is not None:
    cc = tuple(np.asarray(correct_colors, np.float32).flatten().tolist())
  return _bayer_to_rgb(jnp.asarray(bayer), pattern, cc, in_dtype,
                       out_dtype, method)


@partial(jax.jit, static_argnames=("pixel_order",))
def _rgb_to_bayer(image, pixel_order):
  h, w = image.shape[:2]
  hh, wh = h // 2, w // 2
  p1, p2, p3, p4 = pixel_order
  x = image.reshape(hh, 2, wh, 2, 3)
  quad = jnp.stack([
      jnp.stack([x[:, 0, :, 0, p1], x[:, 0, :, 1, p2]], axis=-1),
      jnp.stack([x[:, 1, :, 0, p3], x[:, 1, :, 1, p4]], axis=-1),
  ], axis=1)  # (hh, 2, wh, 2)
  return quad.reshape(h, w)


def rgb_to_bayer(image, pattern: BayerPattern = BayerPattern.RGGB):
  """Mosaic an RGB image to a single-channel CFA by 2x2 phase sampling
  (reference bayer.py:101-112,193-198)."""
  image = jnp.asarray(image)
  if image.ndim != 3 or image.shape[2] != 3:
    raise ValueError(f"image must be RGB (H, W, 3), got {image.shape}")
  return _rgb_to_bayer(jnp.asarray(image), pattern.pixel_order)
