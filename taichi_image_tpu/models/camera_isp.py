"""Multi-camera ISP pipeline: packed RAW -> demosaic+WB/CCM -> resize ->
EMA exposure metering -> Reinhard/linear tonemap -> output transform.

Reference: ``taichi_image/camera_isp.py`` (423 LoC). The reference drives
~4+2N separate Taichi kernel launches per multi-camera frame step with
host-side control (SURVEY.md §3.2); here the WHOLE step is one jitted,
donated function over a uniform camera batch:

    step(metrics, raws) -> (new_metrics, u8 outputs)

so XLA fuses decode -> demosaic -> resize -> metering -> tonemap into a
few passes, and the EMA vec9 metering state is explicit functional state
(the only cross-frame state, reference camera_isp.py:267,376-385).

vec9 metering layout (reference camera_isp.py:102-115):
    [bounds.min, bounds.max, log_bounds.min, log_bounds.max,
     log_mean, mean, rgb_mean(3)]

Multi-camera scaling: cameras shard across devices on a mesh axis; the
metering reduction becomes psum/pmin/pmax collectives over that axis (see
taichi_image_tpu/parallel/). This replaces the reference's single-GPU
multi-launch batching (camera_isp.py:399-401).
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from taichi_image_tpu import types
from taichi_image_tpu.ops import bayer as bayer_ops
from taichi_image_tpu.ops import interpolate, packed
from taichi_image_tpu.ops.bayer import (cfa_phases, demosaic_phases,
                                        phases_to_planar, subsample_hw)
from taichi_image_tpu.ops.color import rgb_gray
from taichi_image_tpu.ops.interpolate import ImageTransform, _axis_samples
from taichi_image_tpu.utils import debug as debug_util
from taichi_image_tpu.utils.bounds import lerp

__all__ = ["camera_isp", "Camera16", "Camera32", "CameraBF16",
           "PlanarImage", "moving_average", "default_cc",
           "metering_update", "reinhard_apply", "linear_apply",
           "fused_isp_step"]


class PlanarImage:
  """Device image handle for the per-image (reference-parity) API.

  The reference's loaders hand out interleaved (H, W, 3) images
  (camera_isp.py:318-403). This handle keeps the image in the
  framework's native device forms — 12-channel Bayer PHASE planes
  (N-less (12, H/2, W/2), what the loaders produce) or planar (C, H, W)
  (what the tonemaps produce as u8) — and presents the
  reference's interleaved contract only at the numpy/host boundary,
  where the conversion is a cheap host reshape/view:

      img = isp.load_packed12(raw)      # device phase planes inside
      np.asarray(img).shape             # (H, W, 3) — reference layout

  All per-image methods (``tonemap_*``, ``update_metering``,
  ``resize_image``) accept and return these handles (phase-backed
  handles flow through the SAME phase-form pipeline as the fused step);
  raw HWC arrays are also accepted (converted on entry).

  Handles can additionally be LAZY: the loaders capture the raw bytes +
  the rig's loader configuration instead of dispatching a per-image
  decode program. A later batch consumer (``tonemap_*``,
  ``update_metering``) decodes the whole camera set in ONE program —
  the reference's per-image call pattern (camera_isp.py:318-403) then
  costs the same device work as the fused step instead of N separate
  decode+demosaic programs. Forcing a lazy handle (``np.asarray``,
  ``.planar``) decodes just that image; values are identical either way
  (the batch axis only vectorizes the per-image math). Handles produced
  by a batch consumer share the batch array (``_batch``) and slice out
  their image only when individually forced.
  """

  __slots__ = ("_planar", "_phases", "_lazy", "_batch")

  def __init__(self, planar=None, phases=None, lazy=None, batch=None):
    if sum(x is not None for x in (planar, phases, lazy, batch)) != 1:
      raise ValueError("exactly one of planar/phases/lazy/batch")
    self._planar = planar
    self._phases = phases
    self._lazy = lazy      # (raws1, fmt, ids_format, work_dtype,
    #                         pattern, cc, resize_plan)
    self._batch = batch    # (form, (N, ...) array, index)

  def _force(self):
    """Materialize device storage into _planar/_phases (idempotent)."""
    if self._planar is None and self._phases is None:
      if self._batch is not None:
        form, arr, i = self._batch
        if form == "phases":
          self._phases = arr[i]
        else:
          self._planar = arr[i]
        self._batch = None
      else:
        raws1, fmt, ids, wd, pattern, cc, plan = self._lazy
        out = _jit_load_planar(raws1, fmt, ids, wd, pattern, cc, plan)
        if plan is None:
          self._phases = out[0]
        else:
          self._planar = out[0]
        self._lazy = None
    return self

  @property
  def shape(self):
    if self._lazy is not None:  # computable without forcing
      raws1, fmt, _, _, _, _, plan = self._lazy
      if plan is not None:
        (w_out, h_out), _ = plan
        return (h_out, w_out, 3)
      h, w_raw = raws1.shape[-2], raws1.shape[-1]
      return (h, decoded_width(fmt, w_raw), 3)
    if self._batch is not None:
      form, arr, _ = self._batch
      if form == "phases":
        _, _, hh, wh = arr.shape
        return (2 * hh, 2 * wh, 3)
      _, c, h, w = arr.shape
      return (h, w, c)
    if self._planar is not None:
      c, h, w = self._planar.shape
      return (h, w, c)
    _, hh, wh = self._phases.shape
    return (2 * hh, 2 * wh, 3)

  @property
  def dtype(self):
    if self._lazy is not None:
      return np.dtype(types.canonical_dtype(self._lazy[3]))
    if self._batch is not None:
      return self._batch[1].dtype
    a = self._planar if self._planar is not None else self._phases
    return a.dtype

  @property
  def planar(self):
    """Device planar (C, H, W) view — interleaves phase-backed handles
    ON DEVICE (costly for 16-bit dtypes at 4K; prefer the numpy
    boundary or phase-form consumers)."""
    self._force()
    if self._planar is None:
      return phases_to_planar(self._phases[None])[0]
    return self._planar

  def __array__(self, dtype=None, copy=None):
    self._force()
    if self._planar is not None:
      a = np.moveaxis(np.asarray(self._planar), 0, -1)
    else:
      x12 = np.asarray(self._phases)
      _, hh, wh = x12.shape
      # host-side phases_to_planar + HWC: (pc, pr, c, hh, wh) ->
      # (hh, pr, wh, pc, c) -> one C-order copy
      a = (x12.reshape(2, 2, 3, hh, wh).transpose(3, 1, 4, 0, 2)
           .reshape(2 * hh, 2 * wh, 3))
    if dtype is not None:
      a = a.astype(dtype, copy=False)
    return np.array(a, copy=True) if copy else a

  def block_until_ready(self):
    self._force()
    (self._planar if self._planar is not None
     else self._phases).block_until_ready()
    return self

  def __repr__(self):
    if self._lazy is not None:
      form = "lazy"
    elif self._batch is not None:
      form = f"batch[{self._batch[2]}]/{self._batch[0]}"
    else:
      form = "planar" if self._planar is not None else "phases"
    return (f"PlanarImage(hwc_shape={self.shape}, dtype={self.dtype}, "
            f"form={form})")


def _to_planar(im):
  """Image handle/array -> planar (C, H, W) device array."""
  if isinstance(im, PlanarImage):
    return im.planar
  x = jnp.asarray(im)
  if x.ndim == 3 and x.shape[-1] in (1, 3, 4):
    return jnp.moveaxis(x, -1, 0)
  raise ValueError(f"expected an (H, W, C) image or PlanarImage, got "
                   f"shape {x.shape}")


def moving_average(old, new, alpha):
  """Host EMA helper (reference camera_isp.py:15-19)."""
  if old is None:
    return new
  return (1 - alpha) * old + alpha * new


# Default 3x3 color-correction matrix (reference camera_isp.py:230-234).
default_cc = np.array([
    [1.75, -0.25, -0.30],
    [-0.10, 1.40, -0.30],
    [-0.05, -0.55, 2.10],
])

_DEFAULT_WB = np.array([1.8, 1.0, 2.1])


# --------------------------------------------------------------------------
# Functional core — pure, jittable, collective-aware.
# --------------------------------------------------------------------------

def metering_update(images, prev, t, axis_name=None, n_total=None):
  """One EMA metering update from a batch of strided RGB crops.

  Mirrors the reference two-pass reduction + double EMA blend exactly
  (camera_isp.py:142-166): global bounds -> blend with prev -> normalized
  stats over the blended bounds -> blend the whole vec9 with prev.

  ``axis_name``: if set, the batch axis is sharded over that mesh axis and
  the reductions complete with pmin/pmax/psum collectives over ICI.
  """
  x = images.astype(jnp.float32)
  bmin, bmax = jnp.min(x), jnp.max(x)
  if axis_name is not None:
    bmin = jax.lax.pmin(bmin, axis_name)
    bmax = jax.lax.pmax(bmax, axis_name)
  b = lerp(t, jnp.stack([bmin, bmax]), prev[:2])

  scaled = (x - b[0]) / (b[1] - b[0] + 1e-6)
  gray = rgb_gray(scaled)
  log_gray = jnp.log(jnp.maximum(gray, 1e-4))

  log_min, log_max = jnp.min(log_gray), jnp.max(log_gray)
  sums = jnp.stack([jnp.sum(log_gray), jnp.sum(gray),
                    *[jnp.sum(scaled[..., c]) for c in range(3)]])
  if axis_name is not None:
    log_min = jax.lax.pmin(log_min, axis_name)
    log_max = jax.lax.pmax(log_max, axis_name)
    sums = jax.lax.psum(sums, axis_name)
  if n_total is None:
    n_total = images.shape[0] * images.shape[1] * images.shape[2]

  stats = jnp.concatenate([b, jnp.stack([log_min, log_max]),
                           sums / n_total])
  return lerp(t, stats, prev)


def reinhard_apply(image, metrics, gamma, intensity, light_adapt,
                   color_adapt, work_dtype):
  """ISP-variant Reinhard (reference camera_isp.py:177-218): normalize by
  the EMA image bounds, Reinhard map, then gamma normalized by the frame's
  own max, to u8. ``image`` may have leading batch dims."""
  m = metrics
  log_min, log_max, log_mean = m[2], m[3], m[4]
  key = (log_max - log_mean) / (log_max - log_min)
  map_key = 0.3 + 0.7 * jnp.power(key, 1.4)

  x = image.astype(jnp.float32)
  scaled = (x - m[0]) / (m[1] - m[0])
  gray = rgb_gray(scaled)[..., None]
  if isinstance(color_adapt, float) and color_adapt == 0.0:
    # exact per-pixel specialization (see reinhard_map_ca)
    adapt_mean = lerp(light_adapt, m[5], gray)
    adapt = jnp.power(jnp.exp(-intensity) * adapt_mean, map_key)
  else:
    mean = lerp(color_adapt, m[5], m[6:9])
    adapt_color = lerp(color_adapt, gray, scaled)
    adapt_mean = lerp(light_adapt, mean, adapt_color)
    adapt = jnp.power(jnp.exp(-intensity) * adapt_mean, map_key)
  p = scaled * (1.0 / (adapt + scaled))

  # Dark pixels below the EMA bounds give scaled < 0 and the pow above
  # produces NaN — the reference's CUDA atomicMax IGNORES NaN (fmaxf
  # semantics, camera_isp.py:213), so only those pixels are corrupted, not
  # the whole frame. Replicate: NaN-ignoring max, NaN output pixels -> 0.
  p = jnp.where(jnp.isnan(p), 0.0, p)

  # the reference stores p in the working dtype, then reduces max over the
  # pre-cast f32 values and reads back the cast image (camera_isp.py:211-218)
  p_cast = types.store_as(p, work_dtype)
  axes = tuple(range(p.ndim - 3, p.ndim))  # per-image max over (h, w, c)
  max_out = jnp.maximum(1e-6, jnp.max(p, axis=axes, keepdims=True))
  out = p_cast.astype(jnp.float32) / max_out
  if not (isinstance(gamma, float) and gamma == 1.0):
    out = _gamma_pow(out, 1.0 / gamma)
  return jnp.clip(255.0 * out, 0, 255).astype(jnp.uint8)


def linear_apply(image, metrics, gamma):
  """ISP-variant linear tonemap (reference camera_isp.py:220-227)."""
  x = image.astype(jnp.float32)
  inv_range = 1.0 / (metrics[1] - metrics[0])
  y = jnp.clip((x - metrics[0]) * inv_range, 0.0, None)
  if not (isinstance(gamma, float) and gamma == 1.0):
    y = _gamma_pow(y, 1.0 / gamma)
  return jnp.clip(jnp.clip(y, 0.0, 1.0) * 255.0, 0, 255).astype(jnp.uint8)


# --------------------------------------------------------------------------
# ISP driver class.
# --------------------------------------------------------------------------

class _ISPBase:
  """Per-rig ISP state + per-frame driver (reference camera_isp.py:237-413).

  All heavy work happens in jitted fused steps; this object only holds
  configuration and the vec9 EMA metering state.
  """

  _work_dtype: np.dtype = None  # set by camera_isp()

  def __init__(self,
               bayer_pattern: bayer_ops.BayerPattern,
               scale: Optional[float] = None,
               resize_width: int = 0,
               moving_alpha: float = 0.1,
               correct_colors: bool = False,
               white_balance: np.ndarray = _DEFAULT_WB,
               color_correction: np.ndarray = default_cc,
               transform: ImageTransform = ImageTransform.none,
               device=None,
               metering_stride: int = 8):
    if scale is not None and resize_width != 0:
      raise ValueError("Cannot specify both scale and resize_width")
    self.bayer_pattern = bayer_pattern
    self.moving_alpha = moving_alpha
    self.scale = scale
    self.resize_width = resize_width
    self.transform = transform
    self.metering_stride = metering_stride
    self.correct_colors = correct_colors
    self.white_balance = np.asarray(white_balance, np.float64)
    self.color_correction = np.asarray(color_correction, np.float64)
    self.metrics = None
    self.device = device  # accepted for API parity; placement is via jax

  def set(self, moving_alpha: Optional[float] = None,
          resize_width: Optional[int] = None,
          scale: Optional[float] = None,
          correct_colors: Optional[bool] = None,
          white_balance: Optional[np.ndarray] = None,
          color_correction: Optional[np.ndarray] = None,
          transform: Optional[ImageTransform] = None):
    """Runtime reconfiguration (reference camera_isp.py:270-300)."""
    if moving_alpha is not None:
      self.moving_alpha = moving_alpha
    if resize_width is not None:
      self.resize_width = resize_width
      self.scale = None
    if scale is not None:
      self.scale = scale
      self.resize_width = 0
    if transform is not None:
      self.transform = transform
    if correct_colors is not None:
      self.correct_colors = correct_colors
    if white_balance is not None:
      self.white_balance = np.asarray(white_balance, np.float64)
    if color_correction is not None:
      self.color_correction = np.asarray(color_correction, np.float64)

  # -- configuration-derived values ---------------------------------------

  @property
  def color_correct_matrix(self) -> Optional[np.ndarray]:
    """CCM with white-balance gains folded into its columns
    (reference camera_isp.py:360-369)."""
    if self.correct_colors:
      cc = self.color_correction.copy()
      cc[:, :3] *= self.white_balance
      return cc
    return None

  def _cc_tuple(self):
    cc = self.color_correct_matrix
    if cc is None:
      return None
    return tuple(np.asarray(cc, np.float32).flatten().tolist())

  def _resize_plan(self, h: int, w: int):
    """(output_size, scale) or None (reference camera_isp.py:302-315)."""
    if self.resize_width > 0:
      scale = self.resize_width / w
      return (self.resize_width, round(h * scale)), scale
    if self.scale is not None:
      return (round(w * self.scale), round(h * self.scale)), self.scale
    return None

  def resize_image(self, image):
    """Apply the rig's resize policy to one RGB image
    (reference camera_isp.py:302-315). Accepts a :class:`PlanarImage`
    or an (H, W, C) array; returns a :class:`PlanarImage`."""
    plan = self._resize_plan(image.shape[0], image.shape[1])
    if plan is None:
      return (image if isinstance(image, PlanarImage)
              else PlanarImage(_to_planar(image)))
    size, scale = plan
    if isinstance(image, PlanarImage):
      image._force()
    if isinstance(image, PlanarImage) and image._phases is not None:
      return PlanarImage(_resize_from_phases(
          image._phases[None], size, scale, self._work_dtype)[0])
    return PlanarImage(
        _resize_planar(_to_planar(image)[None], size, scale,
                       self._work_dtype)[0])

  def metering_images(self, images: List, t: float, prev, stride: int = 8):
    """One metering update over strided crops (reference
    camera_isp.py:168-175); functional — returns the new vec9 without
    consuming ``prev`` (the donating jit gets a fresh copy)."""
    form, batch = self._batch_of(images, stride)
    prev = jnp.array(np.asarray(prev), jnp.float32)  # fresh buffer
    fn = (_jit_metering_phases if form == "phases"
          else _jit_metering_planar)
    return fn(batch, prev, jnp.float32(t), stride)

  # -- batch assembly for the list APIs -------------------------------------

  @staticmethod
  def _lazy_key(images):
    """Shared loader args when every image is an UNFORCED lazy handle of
    the same raw shape and configuration, else None."""
    if not images or not all(
        isinstance(im, PlanarImage) and im._lazy is not None
        and im._planar is None and im._phases is None for im in images):
      return None
    key = images[0]._lazy[1:]
    shape = images[0]._lazy[0].shape
    if all(im._lazy[1:] == key and im._lazy[0].shape == shape
           for im in images):
      return key
    return None

  @staticmethod
  def _shared_batch(images):
    """(form, batch) when the handles are exactly the slices of one
    batch array in order (a previous batch consumer's output), else
    None — avoids re-stacking 300 MB that is already stacked."""
    if not images or not all(
        isinstance(im, PlanarImage) and im._batch is not None
        for im in images):
      return None
    form, arr, _ = images[0]._batch
    if arr.shape[0] == len(images) and all(
        im._batch[1] is arr and im._batch[0] == form
        and im._batch[2] == i for i, im in enumerate(images)):
      return form, arr
    return None

  def _batch_of(self, images: List, stride: int):
    """Assemble a device batch from image handles/arrays:
    ('phases', (N, 12, hh, wh)) when the phase fast path applies (even
    metering stride), else ('planar', (N, C, H, W)).

    Unforced lazy handles with identical loader configuration decode as
    ONE batched program (and become shared-batch handles); handles that
    already share a batch array are reused without re-stacking."""
    key = self._lazy_key(images)
    if key is not None:
      raws = jnp.concatenate([im._lazy[0] for im in images])
      out = _jit_load_planar(raws, *key)
      form = "phases" if key[-1] is None else "planar"
      for i, im in enumerate(images):
        im._batch = (form, out, i)
        im._lazy = None
    else:
      shared = self._shared_batch(images)
      if shared is not None:
        form, out = shared
      else:
        for im in images:
          if isinstance(im, PlanarImage):
            im._force()
        if (images and all(isinstance(im, PlanarImage)
                           and im._phases is not None for im in images)):
          form, out = "phases", jnp.stack([im._phases for im in images])
        else:
          form, out = "planar", jnp.stack([_to_planar(im)
                                           for im in images])
    if form == "phases" and stride % 2 != 0:
      # odd stride cannot use the phase metering identity; interleave
      # once at the batch level
      return "planar", phases_to_planar(out)
    return form, out

  # -- loaders (single image, reference API) ------------------------------
  # All loaders run the planar phase core (decode -> demosaic+WB/CCM ->
  # resize) and hand out PlanarImage handles. Without a resize the handle
  # stays in PHASE form, so the downstream tonemap_* run the same phase
  # pipeline as the fused step.

  def _load_one(self, raws1, fmt, ids_format=False):
    """Loaders are LAZY: capture the raw + the rig's loader args (the
    reference loaders' then-current configuration, camera_isp.py:318-373)
    and decode on first use — which for the reference's actual call
    pattern (load all cameras, then one tonemap_* over the list) is a
    single batched program instead of N per-image programs."""
    plan = self._resize_plan_key(raws1, fmt)
    return PlanarImage(lazy=(raws1, fmt, ids_format, self._work_dtype,
                             self.bayer_pattern, self._cc_tuple(), plan))

  def _stack_batch(self, images):
    """-> ('phases', (N, 12, hh, wh)) when the phase fast path applies
    (see :meth:`_batch_of`), else ('planar', (N, C, H, W))."""
    return self._batch_of(images, self.metering_stride)

  def load_packed12(self, image_data, ids_format: bool = False):
    """Packed 12-bit plane -> working-dtype RGB (camera_isp.py:333-340)."""
    image_data = jnp.asarray(image_data)
    debug_util.validate_raw(image_data, "packed12", batch=False)
    return self._load_one(image_data[None], "packed12", ids_format)

  def load_packed16(self, image_data):
    image_data = jnp.asarray(image_data)
    debug_util.validate_raw(image_data, "packed16", batch=False)
    return self._load_one(image_data[None], "packed16")

  def load_16u(self, image):
    return self._load_one(jnp.asarray(image)[None], "u16")

  def load_16f(self, image):
    return self._load_one(jnp.asarray(image)[None], "f16")

  def load_32f(self, image):
    return self._load_one(jnp.asarray(image)[None], "f32")

  # -- state checkpoint/resume ----------------------------------------------
  # The EMA metering vec9 is the only cross-frame state
  # (reference camera_isp.py:267,376-385; SURVEY.md §5 checkpoint/resume).

  def auto_white_balance(self, strength: float = 1.0,
                         max_gain: float = 8.0):
    """Gray-world auto white balance from the EMA metering state.

    The vec9 metering already carries the bounds-scaled per-channel
    means (indices 6:9 — reference camera_isp.py:102-134 packs the same
    stats); gray-world says a scene averages to neutral, so the per-
    channel gains that equalize the means toward the green mean are
    multiplied into ``white_balance`` (green gain stays 1, the
    reference's convention: white_balance=[1.8, 1.0, 2.1]).

    The means are measured AFTER the WB⊙CCM fold, so this is a feedback
    loop exactly like a real rig's AWB: call it once per metering
    update (or occasionally) and the gains converge as the post-WB
    means equalize. WB takes effect only with ``correct_colors=True``
    (the reference applies WB solely via the CCM fold,
    camera_isp.py:360-369). ``strength`` in (0, 1] damps each update
    (gains**strength); gains clamp to [1/max_gain, max_gain].

    No reference counterpart (the reference ships static WB only) —
    a framework extension riding the existing metering collective, so
    it works unchanged under camera sharding.

    RECOMPILE COST: white_balance folds into the CCM, a STATIC argument
    of the jitted step — every distinct gain value compiles a new
    specialization (seconds at 4K/8K). Gains are therefore quantized to
    1/256 steps (invisible next to the u8 output quantization), so the
    loop stops recompiling once converged; still, prefer calling this
    every N frame sets rather than every set while converging.

    Returns the new white_balance (numpy, length 3). Raises if no
    frames have been metered yet."""
    if self.metrics is None:
      raise ValueError("auto_white_balance needs metering state — "
                       "process at least one frame set first")
    means = np.asarray(self.metrics)[6:9].astype(np.float64)
    if not np.isfinite(means).all() or (means <= 1e-6).any():
      raise ValueError(f"degenerate channel means {means} — scene too "
                       "dark or metering not seeded")
    gains = means[1] / means  # -> green gain exactly 1
    gains = gains ** float(strength)
    wb = self.white_balance * gains
    wb = wb / wb[1]  # G==1 convention FIRST, then clamp (clamping
    # before the renormalization could scale R/B back above max_gain
    # whenever the stored G gain was != 1)
    wb = np.clip(wb, 1.0 / max_gain, max_gain)
    # quantize: bounds the jit-cache growth of the CCM static (above)
    # and makes the converged loop a fixed point (no recompiles)
    self.white_balance = np.round(wb * 256.0) / 256.0
    return self.white_balance

  def state_dict(self):
    """Serializable pipeline state (numpy): the EMA metering vec9 and —
    since auto_white_balance made it algorithmic cross-frame state —
    the current white-balance gains."""
    return {"metrics": None if self.metrics is None
            else np.asarray(self.metrics),
            "white_balance": np.asarray(self.white_balance)}

  def load_state(self, state):
    m = state.get("metrics")
    self.metrics = None if m is None else jnp.asarray(m, jnp.float32)
    wb = state.get("white_balance")  # absent in pre-AWB checkpoints
    if wb is not None:
      self.white_balance = np.asarray(wb, np.float64)

  # -- metering ------------------------------------------------------------

  def update_metering(self, images: List):
    """EMA metering over strided crops of all cameras
    (reference camera_isp.py:376-385): first call seeds with t=0.

    The strided crop runs inside the jit (subsample_hw)."""
    form, batch = self._stack_batch(images)
    self._update_metering_batch(form, batch)

  def _update_metering_batch(self, form, batch):
    if self.metrics is None:
      prev = jnp.zeros(9, jnp.float32)
      t = 0.0
    else:
      prev = self.metrics
      t = 1.0 - self.moving_alpha
    fn = (_jit_metering_phases if form == "phases"
          else _jit_metering_planar)
    self.metrics = fn(batch, prev, jnp.float32(t), self.metering_stride)

  # -- tonemap -------------------------------------------------------------
  # Phase-backed batches (the loaders' native form) run the fused
  # step's phase tail (u8-only interleave, phase-space transform);
  # planar/HWC inputs use the planar tail.

  def tonemap_only(self, image, metrics, gamma, intensity, light_adapt,
                   color_adapt):
    """Tonemap one image with explicit metrics (camera_isp.py:387-390)."""
    if isinstance(image, PlanarImage):
      image._force()
    if isinstance(image, PlanarImage) and image._phases is not None:
      out = _jit_reinhard_phases(
          image._phases[None], jnp.asarray(metrics), float(gamma),
          float(intensity), float(light_adapt), float(color_adapt),
          self._work_dtype, self.transform)
    else:
      out = _jit_reinhard_planar(
          _to_planar(image)[None], jnp.asarray(metrics), float(gamma),
          float(intensity), float(light_adapt), float(color_adapt),
          self._work_dtype, self.transform)
    return PlanarImage(out[0])

  def tonemap_reinhard(self, images: List, gamma: float = 1.0,
                       intensity: float = 1.0, light_adapt: float = 1.0,
                       color_adapt: float = 0.0):
    """Shared metering update + per-camera Reinhard + output transform
    (reference camera_isp.py:394-403). Phase/planar throughout; returns
    :class:`PlanarImage` u8 handles."""
    out = self._tonemap_fused_lazy(images, "reinhard", float(gamma),
                                   float(intensity), float(light_adapt),
                                   float(color_adapt))
    if out is not None:
      return out
    form, batch = self._stack_batch(images)
    self._update_metering_batch(form, batch)
    fn = (_jit_reinhard_phases if form == "phases"
          else _jit_reinhard_planar)
    out = fn(batch, self.metrics, float(gamma), float(intensity),
             float(light_adapt), float(color_adapt), self._work_dtype,
             self.transform)
    return [PlanarImage(o) for o in out]

  def tonemap_linear(self, images: List, gamma: float = 1.0):
    """Reference camera_isp.py:405-413."""
    out = self._tonemap_fused_lazy(images, "linear", float(gamma))
    if out is not None:
      return out
    form, batch = self._stack_batch(images)
    self._update_metering_batch(form, batch)
    fn = (_jit_linear_phases if form == "phases"
          else _jit_linear_planar)
    out = fn(batch, self.metrics, float(gamma), self.transform)
    return [PlanarImage(o) for o in out]

  def _tonemap_fused_lazy(self, images, tonemap, gamma, intensity=1.0,
                          light_adapt=1.0, color_adapt=0.0):
    """Fused fast path for the reference call pattern: when every image
    is an unforced lazy handle with identical loader configuration, the
    composed load_* -> tonemap_* flow IS the fused step — decode ->
    demosaic -> metering EMA -> tonemap -> transform in ONE program,
    instead of N decode programs + a metering
    program + a tonemap program. Returns None when the batch is mixed
    (forced handles, raw arrays, differing configs) — the staged path
    handles those. Loader args are the ones captured at load time,
    matching the reference's eager-loader semantics under set()."""
    key = self._lazy_key(images)
    if key is None:
      return None
    fmt, ids, wd, pattern, cc, plan = key
    raws = jnp.concatenate([im._lazy[0] for im in images])
    if self.metrics is None:
      prev, t = jnp.zeros(9, jnp.float32), 0.0
    else:
      prev, t = self.metrics, 1.0 - self.moving_alpha
    step = (_jit_fused_step_checked if debug_util.debug_enabled()
            else _jit_fused_step)
    new_metrics, out = step(
        raws, prev, jnp.float32(t), gamma, intensity, light_adapt,
        color_adapt, fmt, ids, wd, pattern, cc, plan,
        self.metering_stride, self.transform, tonemap)
    self.metrics = new_metrics
    return [PlanarImage(batch=("planar", out, i))
            for i in range(len(images))]

  # -- fused step -----------------------------------------------------------

  def process(self, raws, fmt: str = "packed12", ids_format: bool = False,
              gamma: float = 1.0, intensity: float = 1.0,
              light_adapt: float = 1.0, color_adapt: float = 0.0,
              tonemap: str = "reinhard", layout: str = "planar",
              color_format: str = "rgb"):
    """Fused whole-rig step: decode -> demosaic+WB/CCM -> resize ->
    metering EMA -> tonemap -> transform, in ONE jitted call over the
    camera batch. Extension (SURVEY.md §7 step 4); equivalent to
    load_* + tonemap_* but without host round-trips.

    ``raws``: (n_cameras, H, W_bytes|W) batch. Returns u8 outputs and
    updates the EMA state. ``layout``: 'planar' (default) returns the
    native (n, 3, h', w') device array; 'hwc' returns a host numpy
    (n, h', w', 3) view (one device->host transfer + free moveaxis).
    ``color_format='yuv420'`` returns planar I420 ``(Y, UV)`` u8 device
    arrays instead (``layout`` ignored); it composes with resize and
    output transforms (even output dims required).
    """
    raws = jnp.asarray(raws)
    debug_util.validate_raw(raws, fmt)
    if self.metrics is None:
      prev = jnp.zeros(9, jnp.float32)
      t = 0.0
    else:
      prev = self.metrics
      t = 1.0 - self.moving_alpha
    step = (_jit_fused_step_checked if debug_util.debug_enabled()
            else _jit_fused_step)
    new_metrics, out = step(
        raws, prev, jnp.float32(t), float(gamma),
        float(intensity), float(light_adapt), float(color_adapt),
        fmt, ids_format, self._work_dtype, self.bayer_pattern,
        self._cc_tuple(), self._resize_plan_key(raws, fmt),
        self.metering_stride, self.transform, tonemap,
        color_format=color_format)
    self.metrics = new_metrics
    if color_format != "rgb":
      return out
    if layout == "hwc":
      return np.moveaxis(np.asarray(out), 1, -1)
    return out

  def process_large(self, raws, n_bands: int = 4, fmt: str = "packed12",
                    ids_format: bool = False, gamma: float = 1.0,
                    intensity: float = 1.0, light_adapt: float = 1.0,
                    color_adapt: float = 0.0, tonemap: str = "reinhard",
                    layout: str = "planar", color_format: str = "rgb",
                    driver: str = "auto"):
    """Fused step as a sequence of row-band programs (e.g. 8K frames with
    bounded per-program memory): halo overlap and staged global
    reductions — same outputs as :meth:`process` (within 1 u8 count),
    including the rig's resize policy (bands partition the OUTPUT rows)
    and output transform (applied on the assembled output). See
    models/large.py.
    """
    from taichi_image_tpu.models import large
    raws = jnp.asarray(raws)
    debug_util.validate_raw(raws, fmt)
    if self.metrics is None:
      prev, t = jnp.zeros(9, jnp.float32), 0.0
    else:
      prev, t = self.metrics, 1.0 - self.moving_alpha
    new_metrics, out = large.process_banded(
        raws, prev, t, n_bands=n_bands, fmt=fmt, ids_format=ids_format,
        work_dtype=self._work_dtype, pattern=self.bayer_pattern,
        cc=self._cc_tuple(), stride=self.metering_stride, gamma=gamma,
        intensity=intensity, light_adapt=light_adapt,
        color_adapt=color_adapt, tonemap=tonemap,
        color_format=color_format,
        resize_plan=self._resize_plan_key(raws, fmt),
        transform=self.transform, driver=driver)
    self.metrics = new_metrics
    if color_format != "rgb":
      return out
    if layout == "hwc":
      return np.moveaxis(np.asarray(out), 1, -1)
    return out

  def process_stream(self, raw_iter, prefetch: int = 2, **kwargs):
    """Streaming driver: iterate raw frame batches through the fused step
    with device/host overlap.

    JAX dispatch is async, so keeping ``prefetch`` step results in flight
    overlaps host upload of frame t+1 with device compute of frame t —
    the functional analogue of the reference's ThreadPoolExecutor
    lookahead (scripts/tonemap_scan.py:70-87). Yields outputs in order.
    ``kwargs`` are forwarded to :meth:`process`.

    The deque holds in-flight DEVICE arrays; ``layout='hwc'`` host
    conversion (which blocks on the step) is deferred to yield time so
    it never collapses the overlap window.
    """
    from collections import deque
    layout = kwargs.pop("layout", "planar")
    to_host = layout == "hwc" and kwargs.get("color_format", "rgb") == "rgb"

    def finish(out):
      return np.moveaxis(np.asarray(out), 1, -1) if to_host else out

    pending = deque()
    for raws in raw_iter:
      pending.append(self.process(np.asarray(raws), layout="planar",
                                  **kwargs))
      if len(pending) > prefetch:
        yield finish(pending.popleft())
    while pending:
      yield finish(pending.popleft())

  def _resize_plan_key(self, raws, fmt):
    h, w_raw = raws.shape[-2], raws.shape[-1]
    plan = self._resize_plan(h, decoded_width(fmt, w_raw))
    return plan if plan is None else (plan[0], plan[1])


# --------------------------------------------------------------------------
# Jitted kernels shared by all ISP instances.
# --------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("fmt", "ids_format", "work_dtype",
                                   "pattern", "cc", "resize_plan"))
def _jit_load_planar(raws, fmt, ids_format, work_dtype, pattern, cc,
                     resize_plan):
  """Per-image-API loader batch core: decode -> demosaic(+CCM) ->
  resize, entirely in phase/planar form. Same stages as the reference's
  load_* -> resize chain (camera_isp.py:333-373) routed through the
  planar pipeline. Returns PHASE form (N, 12, hh, wh) when there is no
  resize (nothing downstream needs the interleave), else the resized
  planar RGB."""
  phases = load_raw_phases(raws, fmt, work_dtype, ids_format)
  wd = types.canonical_dtype(work_dtype)
  x12 = demosaic_phases(phases, pattern, cc=cc, out_dtype=wd)
  if resize_plan is not None:
    size, scale = resize_plan
    return _resize_from_phases(x12, size, scale, work_dtype)
  return x12


@partial(jax.jit, static_argnames=("stride",), donate_argnums=(1,))
def _jit_metering_planar(batch, prev, t, stride):
  from taichi_image_tpu.ops.bayer import subsample_hw as _sub
  return metering_update_ca(_sub(batch, stride, stride), prev, t)


@partial(jax.jit, static_argnames=("stride",), donate_argnums=(1,))
def _jit_metering_phases(x12, prev, t, stride):
  # full-res stride-s pixels are exactly phase (0, 0) channels at
  # half-res stride s/2 (the fused step's metering identity)
  from taichi_image_tpu.ops.bayer import subsample_hw as _sub
  s = stride // 2
  return metering_update_ca(_sub(x12[:, 0:3], s, s), prev, t)


# The tonemap scalars are STATIC Python floats: constant per rig in
# practice, and staticness lets the exact specializations in
# reinhard_apply_ca/reinhard_map_ca (per-pixel adapt for color_adapt ==
# 0, no pow for gamma == 1 — the reference defaults) fire. A new value
# costs one retrace.
@partial(jax.jit, static_argnames=("gamma", "intensity", "light_adapt",
                                   "color_adapt", "work_dtype",
                                   "transform"))
def _jit_reinhard_planar(batch, metrics, gamma, intensity, light_adapt,
                         color_adapt, work_dtype, transform):
  out = reinhard_apply_ca(batch, metrics, gamma, intensity, light_adapt,
                          color_adapt, work_dtype)
  return _transform_planar(out, transform)


@partial(jax.jit, static_argnames=("gamma", "transform"))
def _jit_linear_planar(batch, metrics, gamma, transform):
  out = linear_apply_ca(batch, metrics, gamma)
  return _transform_planar(out, transform)


@partial(jax.jit, static_argnames=("gamma", "intensity", "light_adapt",
                                   "color_adapt", "work_dtype",
                                   "transform"))
def _jit_reinhard_phases(x12, metrics, gamma, intensity, light_adapt,
                         color_adapt, work_dtype, transform):
  """Phase-form tonemap for phase-backed image batches: identical tail
  to the fused step (the interleave happens once, on u8, transform in
  phase space)."""
  n, _, hh, wh = x12.shape
  out12 = reinhard_apply_ca(x12.reshape(n, 4, 3, hh, wh), metrics,
                            gamma, intensity, light_adapt, color_adapt,
                            work_dtype)
  return planar_from_phases_transformed(out12.reshape(n, 12, hh, wh),
                                        transform)


@partial(jax.jit, static_argnames=("gamma", "transform"))
def _jit_linear_phases(x12, metrics, gamma, transform):
  n, _, hh, wh = x12.shape
  out12 = linear_apply_ca(x12.reshape(n, 4, 3, hh, wh), metrics, gamma)
  return planar_from_phases_transformed(out12.reshape(n, 12, hh, wh),
                                        transform)


# --------------------------------------------------------------------------
# Planar pipeline (channels at axis -3; images planar/phase-planar).
#
# The fused pipeline keeps everything planar: CFA phase planes ->
# 12-channel phase-RGB -> tonemap -> planar (N, 3, H, W) u8. See
# taichi_image_tpu/ops/bayer.py (planar section).
# --------------------------------------------------------------------------


def decoded_width(fmt: str, w_raw: int) -> int:
  """Decoded pixel width of a raw plane whose last dim is ``w_raw``
  (bytes for the packed formats: 3 bytes -> 2 px for packed12, 2 bytes
  -> 1 px for packed16; element count otherwise)."""
  return {"packed12": w_raw * 2 // 3, "packed16": w_raw // 2}.get(fmt,
                                                                  w_raw)


def load_raw_phases(raws, fmt: str, work_dtype, ids_format: bool = False):
  """Decode a batch of raw planes directly to normalized CFA *phase
  planes* (N, 4, H/2, W/2) without materializing interleaved layouts.

  packed12: the 3 byte planes b0/b1/b2 (lane stride 3) give the even and
  odd CFA columns directly (reference bit layouts packed.py:12-55), and
  row-parity slicing completes the phase split — planar ops only.
  """
  wd = types.canonical_dtype(work_dtype)
  scale = types.scale_of(wd)
  if fmt == "packed12":
    b0 = raws[:, :, 0::3].astype(jnp.uint16)
    b1 = raws[:, :, 1::3].astype(jnp.uint16)
    b2 = raws[:, :, 2::3].astype(jnp.uint16)
    if not ids_format:
      even = ((b1 & 0xF) << 8) | b0
      odd = (b2 << 4) | (b1 >> 4)
    else:
      even = (b0 << 4) | (b2 & 0xF)
      odd = (b1 << 4) | (b2 >> 4)
    phases = jnp.stack([even[:, 0::2], odd[:, 0::2],
                        even[:, 1::2], odd[:, 1::2]], axis=1)
    return types.store_as(phases.astype(jnp.float32)
                          * jnp.float32(scale / 4095.0), wd)
  if fmt == "packed16":
    # byte-quad reshape: pixel-pair bytes (lo_e, hi_e, lo_o, hi_o) split
    # on a free minor-dim-4 view; u16 assembly in exact f32 arithmetic
    # (values <= 65535).
    n, h, wb = raws.shape
    b = raws.reshape(n, h, wb // 4, 4)
    even = (b[..., 1].astype(jnp.float32) * 256.0
            + b[..., 0].astype(jnp.float32))
    odd = (b[..., 3].astype(jnp.float32) * 256.0
           + b[..., 2].astype(jnp.float32))
    phases = jnp.stack([even[:, 0::2], odd[:, 0::2],
                        even[:, 1::2], odd[:, 1::2]], axis=1)
    return types.store_as(phases * jnp.float32(scale / 65535.0), wd)
  if fmt == "u16":
    phases = cfa_phases(raws)
    return types.store_as(phases.astype(jnp.float32) / 65535.0, wd)
  if fmt in ("f32", "f16"):
    return types.store_as(cfa_phases(raws), wd)
  raise ValueError(f"unknown raw format {fmt}")


def metering_update_ca(x, prev, t, axis_name=None, n_total=None):
  """EMA metering update with channels at axis -3 (planar layout).

  Same numbers as :func:`metering_update` (reference camera_isp.py:142-166);
  ``x`` is (N, 3, hs, ws) normalized float.
  """
  x = x.astype(jnp.float32)
  bmin, bmax = jnp.min(x), jnp.max(x)
  if axis_name is not None:
    bmin = jax.lax.pmin(bmin, axis_name)
    bmax = jax.lax.pmax(bmax, axis_name)
  b = lerp(t, jnp.stack([bmin, bmax]), prev[:2])

  scaled = (x - b[0]) / (b[1] - b[0] + 1e-6)
  r, g, bch = scaled[:, 0], scaled[:, 1], scaled[:, 2]
  gray = 0.299 * r + 0.587 * g + 0.114 * bch
  log_gray = jnp.log(jnp.maximum(gray, 1e-4))

  log_min, log_max = jnp.min(log_gray), jnp.max(log_gray)
  sums = jnp.stack([jnp.sum(log_gray), jnp.sum(gray),
                    jnp.sum(r), jnp.sum(g), jnp.sum(bch)])
  if axis_name is not None:
    log_min = jax.lax.pmin(log_min, axis_name)
    log_max = jax.lax.pmax(log_max, axis_name)
    sums = jax.lax.psum(sums, axis_name)
  if n_total is None:
    n_total = x.shape[0] * x.shape[2] * x.shape[3]
  stats = jnp.concatenate([b, jnp.stack([log_min, log_max]),
                           sums / n_total])
  return lerp(t, stats, prev)


def reinhard_map_ca(x, metrics, intensity, light_adapt, color_adapt):
  """The pre-gamma Reinhard map with channels at axis -3: returns the
  f32 ``p`` values (NaN pixels zeroed — CUDA atomicMax ignore-NaN
  semantics, reference camera_isp.py:213). Split out so banded/sharded
  drivers can insert the global per-image max reduction between the map
  and the gamma stage.

  When ``color_adapt`` is the Python float 0.0 (the reference default),
  the adapt chain is computed once per PIXEL instead of per channel —
  bitwise-identical (with ca == 0, ``lerp(0, a, b) == a`` exactly for
  finite b, so all three channels' adapt values coincide) but with 3x
  fewer pow/exp evaluations, which dominate the tonemap arithmetic.
  """
  m = metrics
  key = (m[3] - m[4]) / (m[3] - m[2])
  map_key = 0.3 + 0.7 * jnp.power(key, 1.4)

  xf = x.astype(jnp.float32)
  scaled = (xf - m[0]) / (m[1] - m[0])
  r, g, bch = (scaled[..., 0, :, :], scaled[..., 1, :, :],
               scaled[..., 2, :, :])
  gray = (0.299 * r + 0.587 * g + 0.114 * bch)[..., None, :, :]
  if isinstance(color_adapt, float) and color_adapt == 0.0:
    adapt_mean = lerp(light_adapt, m[5], gray)       # per pixel
    adapt = jnp.power(jnp.exp(-intensity) * adapt_mean, map_key)
  else:
    cdims = (1,) * (x.ndim - 3)
    mean = lerp(color_adapt, m[5],
                m[6:9].reshape(cdims + (3, 1, 1)))
    adapt_color = lerp(color_adapt, gray, scaled)
    adapt_mean = lerp(light_adapt, mean, adapt_color)
    adapt = jnp.power(jnp.exp(-intensity) * adapt_mean, map_key)
  p = scaled * (1.0 / (adapt + scaled))
  return jnp.where(jnp.isnan(p), 0.0, p)


def _gamma_pow(x, inv_gamma):
  """``x ** inv_gamma`` as exp2(log2(x) * c), cheaper than XLA's generic
  jnp.power lowering. Same edge
  semantics for the gamma domain: x == 0 -> log2 -inf -> exp2 -> 0
  (pow(0, c>0) == 0), x < 0 -> NaN (pow of negative with non-integer
  exponent), NaN -> NaN; values agree with pow to f32 ulps (<=1 u8
  count after quantization)."""
  return jnp.exp2(jnp.log2(x) * jnp.float32(inv_gamma))


def reinhard_gamma_ca(p_cast, max_out, gamma):
  """Gamma stage: (p in working dtype, per-image max of the f32 p) -> u8
  (reference camera_isp.py:211-218). ``gamma`` as the Python float 1.0
  (the reference default) skips the pow entirely (IEEE pow(x, 1) == x,
  and numpy's oracle agrees exactly)."""
  max_out = jnp.maximum(1e-6, max_out)
  out = p_cast.astype(jnp.float32) / max_out
  if not (isinstance(gamma, float) and gamma == 1.0):
    out = _gamma_pow(out, 1.0 / gamma)
  return jnp.clip(255.0 * out, 0, 255).astype(jnp.uint8)


def reinhard_map_max_ca(x, metrics, intensity, light_adapt,
                        color_adapt, work_dtype, axis_name=None):
  """Map stage of the ISP Reinhard, channels at axis -3: returns
  ``(p_cast, max_out)`` — the working-dtype map output in FLAT
  ``(n, c_total, H, W)`` form (all channel-like dims of ``x`` merged)
  and the per-image pre-gamma f32 p max shaped ``(n, 1, 1, 1)``.
  Finish with :func:`reinhard_gamma_ca`, THEN reshape the u8."""
  flat = x.reshape(x.shape[0], -1, x.shape[-2], x.shape[-1])
  p = reinhard_map_ca(x, metrics, intensity, light_adapt, color_adapt)
  p_cast = types.store_as(p, work_dtype)
  axes = tuple(range(1, p.ndim))
  max_out = jnp.max(p, axis=axes)
  if axis_name is not None:
    max_out = jax.lax.pmax(max_out, axis_name)
  return (p_cast.reshape(flat.shape),
          max_out.reshape(x.shape[0], 1, 1, 1))


def reinhard_apply_ca(x, metrics, gamma, intensity, light_adapt,
                      color_adapt, work_dtype, axis_name=None):
  """ISP Reinhard with channels at axis -3 (works for planar (N,3,h,w)
  and phase-form (N,4,3,hh,wh)). Same math as :func:`reinhard_apply`;
  map/max routing in :func:`reinhard_map_max_ca`.
  ``axis_name``: mesh axis holding spatial shards of each image — the
  per-image max becomes a pmax collective."""
  cast, max_out = reinhard_map_max_ca(
      x, metrics, intensity, light_adapt, color_adapt, work_dtype,
      axis_name=axis_name)
  return reinhard_gamma_ca(cast, max_out, gamma).reshape(x.shape)


def linear_apply_ca(x, metrics, gamma):
  """ISP linear tonemap, layout-agnostic elementwise."""
  xf = x.astype(jnp.float32)
  inv_range = 1.0 / (metrics[1] - metrics[0])
  y = jnp.clip((xf - metrics[0]) * inv_range, 0.0, None)
  if not (isinstance(gamma, float) and gamma == 1.0):
    y = _gamma_pow(y, 1.0 / gamma)
  return jnp.clip(jnp.clip(y, 0.0, 1.0) * 255.0, 0, 255).astype(jnp.uint8)


def _resize_planar(images, size, scale, work_dtype):
  """Bilinear resize on planar (N, 3, H, W) with reference sampling."""
  h_in, w_in = images.shape[2], images.shape[3]
  w_out, h_out = size
  sy, sx = _plan_scales(h_in, w_in, size, scale)
  r_lo, r_hi, r_f = _axis_samples(h_out, h_in, sy)
  c_lo, c_hi, c_f = _axis_samples(w_out, w_in, sx)
  x = images.astype(jnp.float32)
  top = jnp.take(x, jnp.asarray(r_lo), axis=2)
  bot = jnp.take(x, jnp.asarray(r_hi), axis=2)
  rows = top + jnp.asarray(r_f)[None, None, :, None] * (bot - top)
  left = jnp.take(rows, jnp.asarray(c_lo), axis=3)
  right = jnp.take(rows, jnp.asarray(c_hi), axis=3)
  out = left + jnp.asarray(c_f)[None, None, None, :] * (right - left)
  return types.store_as(out, work_dtype)


# The output transform runs in PHASE SPACE (12-channel planes: the same
# geometric op on the half-res plane grids plus a phase-channel
# permutation, exact because H and W are even), and the interleave runs
# last, so the interleave and the transform are one data movement.
# Permutations below were validated exhaustively against the planar
# path (tests/test_isp.py::test_phase_space_transforms).
_PHASE_TRANSFORM_PERM = {
    ImageTransform.rotate_90: (1, 3, 0, 2),
    ImageTransform.rotate_180: (3, 2, 1, 0),
    ImageTransform.rotate_270: (2, 0, 3, 1),
    ImageTransform.transpose: (0, 2, 1, 3),
    ImageTransform.flip_horiz: (2, 3, 0, 1),
    ImageTransform.flip_vert: (1, 0, 3, 2),
    ImageTransform.transverse: (3, 1, 2, 0),
}


def _transform_phases(x12, t: ImageTransform):
  """ImageTransform on 12-channel phase form (N, 12, hh, wh): the plane
  grids transform with the SAME geometric op; phases permute."""
  if t == ImageTransform.none:
    return x12
  perm4 = _PHASE_TRANSFORM_PERM[t]
  perm12 = [p * 3 + c for p in perm4 for c in range(3)]
  xt = _transform_planar(x12, t)  # same spatial op, channel-agnostic
  return xt[:, jnp.asarray(perm12)]


# (swap, flip_y_axes, flip_x_axes) per transform for the one-shot
# formulation below. swap: the input row axes (ih, pr) land in the
# output X slot (and (iw, pc) in Y); flips reverse an axis PAIR (even
# dims: H-1-(2a+b) == 2(hh-1-a) + (1-b), so flipping full-res y is
# flipping both ih and pr).
_TRANSFORM_SFF = {
    ImageTransform.rotate_90:  (True,  True,  False),
    ImageTransform.rotate_270: (True,  False, True),
    ImageTransform.transpose:  (True,  False, False),
    ImageTransform.transverse: (True,  True,  True),
    ImageTransform.rotate_180: (False, True,  True),
    ImageTransform.flip_vert:  (False, True,  False),
    ImageTransform.flip_horiz: (False, False, True),
}


def planar_from_phases_transformed(out12, t: ImageTransform,
                                   out_dtype=None):
  """(N, 12, hh, wh) -> transformed planar (N, C=3, h', w'), equal to
  ``_transform_planar(phases_to_planar(out12), t)`` bitwise.

  Single-pass formulation: the per-plane geometric op, the phase
  permutation, and the interleave are ALL data movement, so they fold
  into ONE 6-d transpose plus axis flips — e.g. for rotate_90,
  ``out[c, 2*iw+pc, 2*ox+rx] = x6[pc, 1-rx, c, hh-1-ox, iw]``.
  Bitwise-equal to the two-pass route for all 8 transforms."""
  if t == ImageTransform.none:
    return phases_to_planar(out12, out_dtype)
  n, _, hh, wh = out12.shape
  x6 = out12.reshape(n, 2, 2, 3, hh, wh)   # (n, pc, pr, c, ih, iw)
  swap, fy, fx = _TRANSFORM_SFF[t]
  if swap:
    z = x6.transpose(0, 3, 5, 1, 4, 2)     # (n, c, iw, pc, ih, pr)
    ho, wo = 2 * wh, 2 * hh
    ysl, xsl = (4, 5), (2, 3)              # where (ih,pr)/(iw,pc) landed
  else:
    z = x6.transpose(0, 3, 4, 2, 5, 1)     # (n, c, ih, pr, iw, pc)
    ho, wo = 2 * hh, 2 * wh
    ysl, xsl = (2, 3), (4, 5)
  if fy:
    z = jnp.flip(z, axis=ysl)
  if fx:
    z = jnp.flip(z, axis=xsl)
  return z.reshape(n, 3, ho, wo).astype(out_dtype or out12.dtype)


def _plan_scales(h_in, w_in, size, scale):
  """(scale_y, scale_x) for a resize_plan via the public resize API's
  normalization (a bare (size, None) plan previously fed NaN into the
  sample grid)."""
  return interpolate._norm_scale_hw(h_in, w_in, size, scale)


def _resize_from_phases(x12, size, scale, work_dtype, row_band=None):
  """Bilinear resize directly from 12-channel phase form (N, 12, hh, wh)
  -> planar (N, 3, h_out, w_out), bitwise-equal to
  ``_resize_planar(phases_to_planar(x12), ...)``.

  Row/column parities join the gather axes instead of interleaving
  first: a static channel permutation to (c, cp, rp) makes (rp, hh) a
  FREE merged view for the row taps; one major-dim swap then merges
  (cp, wh) for the column taps. Phase index is col-parity-major
  (p = cp*2 + rp — see _PHASE_TRANSFORM_PERM validation).

  ``row_band=(o0, o1, phase_row0, full_h_in)``: banded-driver mode —
  ``x12`` holds only input phase rows [phase_row0, phase_row0 + hh) of
  a ``full_h_in``-row image and the output is rows [o0, o1) of the full
  resize, with GLOBAL tap positions/fractions (the band must cover
  every tap of its output rows; models/large.py plans bands that way).
  Bitwise-equal to slicing rows [o0, o1) of the unbanded result."""
  n, _, hh, wh = x12.shape
  w_out = size[0]
  if row_band is None:
    h_in = 2 * hh
    h_out = size[1]
    o0, o1, prow0 = 0, h_out, 0
  else:
    o0, o1, prow0, h_in = row_band
  w_in = 2 * wh
  sy, sx = _plan_scales(h_in, w_in, size, scale)
  r_lo, r_hi, r_f = _axis_samples(size[1], h_in, sy)
  r_lo, r_hi, r_f = r_lo[o0:o1], r_hi[o0:o1], r_f[o0:o1]
  c_lo, c_hi, c_f = _axis_samples(w_out, w_in, sx)

  perm = [(cp * 2 + rp) * 3 + c
          for c in range(3) for cp in range(2) for rp in range(2)]
  z = x12[:, jnp.asarray(perm)].reshape(n, 3, 2, 2 * hh, wh)
  ri_lo = (r_lo % 2) * hh + (r_lo // 2 - prow0)
  ri_hi = (r_hi % 2) * hh + (r_hi // 2 - prow0)
  top = jnp.take(z, jnp.asarray(ri_lo), axis=3).astype(jnp.float32)
  bot = jnp.take(z, jnp.asarray(ri_hi), axis=3).astype(jnp.float32)
  rows = top + jnp.asarray(r_f)[None, None, None, :, None] * (bot - top)
  rows = jnp.swapaxes(rows, 2, 3).reshape(n, 3, o1 - o0, 2 * wh)
  ci_lo = (c_lo % 2) * wh + c_lo // 2
  ci_hi = (c_hi % 2) * wh + c_hi // 2
  left = jnp.take(rows, jnp.asarray(ci_lo), axis=3)
  right = jnp.take(rows, jnp.asarray(ci_hi), axis=3)
  out = left + jnp.asarray(c_f)[None, None, None, :] * (right - left)
  return types.store_as(out, work_dtype)


def _transform_planar(images, t: ImageTransform):
  """ImageTransform on planar (N, C, H, W) spatial dims."""
  if t == ImageTransform.none:
    return images
  x = images
  if t == ImageTransform.rotate_90:
    return jnp.rot90(x, k=-1, axes=(2, 3))
  if t == ImageTransform.rotate_180:
    return jnp.rot90(x, k=2, axes=(2, 3))
  if t == ImageTransform.rotate_270:
    return jnp.rot90(x, k=1, axes=(2, 3))
  if t == ImageTransform.transpose:
    return jnp.swapaxes(x, 2, 3)
  if t == ImageTransform.flip_horiz:
    return jnp.flip(x, axis=3)
  if t == ImageTransform.flip_vert:
    return jnp.flip(x, axis=2)
  if t == ImageTransform.transverse:
    return jnp.flip(jnp.swapaxes(x, 2, 3), axis=(2, 3))
  raise ValueError(f"unknown transform {t}")


def yuv420_from_planar_u8(out):
  """Tonemapped planar u8 RGB (N, 3, H, W) -> planar I420 u8:
  (Y (N, H, W), UV (N, 2, H/2, W/2)).

  Same per-pixel math as :func:`yuv420_from_phases_u8` (reference
  color/yuv_420.py:38-66 semantics: matrix on the channel-reversed vector,
  min(1, x) clamp, V-then-U plane order), but driven from full-res planar
  RGB so it composes with resize and output transforms. H and W must be
  even.
  """
  from taichi_image_tpu.ops.color import _YUV_M, _YUV_OFFSET
  n, _, h, w = out.shape
  if h % 2 or w % 2:
    raise ValueError(
        f"yuv420 output needs even output dims, got {(h, w)}")
  x = out.astype(jnp.float32) / 255.0
  bgr = x[:, ::-1]
  yuv = jnp.einsum("nchw,dc->ndhw", bgr, jnp.asarray(_YUV_M),
                   precision=jax.lax.Precision.HIGHEST)
  yuv = yuv + jnp.asarray(_YUV_OFFSET, jnp.float32)[None, :, None, None]
  y = jnp.minimum(1.0, yuv[:, 0])
  y_u8 = jnp.clip(y * 255.0, 0, 255).astype(jnp.uint8)
  blocks = yuv[:, 1:3].reshape(n, 2, h // 2, 2, w // 2, 2)
  uv = jnp.minimum(1.0, blocks.mean(axis=(3, 5)))
  uv = uv[:, ::-1]  # V-then-U plane order quirk (yuv_420.py:62-64)
  uv_u8 = jnp.clip(uv * 255.0, 0, 255).astype(jnp.uint8)
  return y_u8, uv_u8


def _yuv420_w6():
  """(6, 12) channel-contraction matrix turning the whole I420
  conversion into ONE dot over the u8 phase channels: rows 0-3 = Y of
  phase p (BT.601 row 0 on that phase's channel-reversed BGR), rows
  4-5 = V, U of the phase mean (rows 2, 1 with each coefficient /4 —
  the 2x2 chroma block mean IS the phase mean, and the matrix is
  linear, so mean-then-matrix == matrix-then-mean up to rounding).
  Channel layout: 12 = 4 phases x 3 (r, g, b)."""
  from taichi_image_tpu.ops.color import _YUV_M
  w = np.zeros((6, 12), np.float32)
  for p in range(4):
    w[p, 3 * p + 2] = float(_YUV_M[0, 0])   # b
    w[p, 3 * p + 1] = float(_YUV_M[0, 1])   # g
    w[p, 3 * p + 0] = float(_YUV_M[0, 2])   # r
  for row, mrow in ((4, 2), (5, 1)):        # V-then-U plane order quirk
    for p in range(4):
      w[row, 3 * p + 2] = float(_YUV_M[mrow, 0]) / 4.0
      w[row, 3 * p + 1] = float(_YUV_M[mrow, 1]) / 4.0
      w[row, 3 * p + 0] = float(_YUV_M[mrow, 2]) / 4.0
  return w


def _yuv420_phases_dot_bf16(out12):
  """I420 from u8 phase-RGB as ONE bf16 channel contraction.

  Rooting the Y and UV chains at a single (6, 12) dot reads the u8
  once. u8 -> bf16 is exact (ints <= 255) and the dot accumulates in
  f32; the bf16-rounded matrix coefficients perturb results by <= ~0.4
  of a count before quantization, so Y/UV can differ from the f32
  two-chain values by 1 count at truncation boundaries — within the
  pipeline's <=1-count contract. bf16 pipeline only: a bf16 dot would
  lose precision for the f32-parity pipelines."""
  from taichi_image_tpu.ops.color import _YUV_OFFSET
  n, _, hh, wh = out12.shape
  w = jnp.asarray(_yuv420_w6(), jnp.bfloat16)
  x = out12.astype(jnp.bfloat16)  # 0..255 ints, exact in bf16
  yuv6 = jnp.einsum("nchw,dc->ndhw", x, w,
                    preferred_element_type=jnp.float32) / 255.0
  off = jnp.asarray([float(_YUV_OFFSET[0])] * 4
                    + [float(_YUV_OFFSET[2]), float(_YUV_OFFSET[1])],
                    jnp.float32)
  yuv6 = jnp.minimum(1.0, yuv6 + off[None, :, None, None])
  u8_6 = jnp.clip(yuv6 * 255.0, 0, 255).astype(jnp.uint8)
  return bayer_ops.phases_to_plane(u8_6[:, :4]), u8_6[:, 4:6]


def yuv420_from_phases_u8(out12, dot: bool = False):
  """Tonemapped u8 phase-RGB (N, 12, hh, wh) -> planar I420 u8:
  (Y (N, H, W), UV (N, 2, hh, wh)).

  Replicates the reference YUV kernel semantics on the quantized u8 RGB
  (color/yuv_420.py:38-66): matrix applied to the channel-reversed
  vector, min(1, x) upper clamp, V-then-U plane order. The 2x2 chroma
  block mean is exactly the mean over the four Bayer phases — in phase
  form the subsampling is free.

  ``dot=True`` (bf16 pipeline) routes through the single-dot
  formulation (:func:`_yuv420_phases_dot_bf16`, <=1 count vs the f32
  chains). The f32 two-chain path below: the u8 phase array is
  deliberately a two-consumer value (one 1-byte materialization read by
  both chains)."""
  if dot:
    return _yuv420_phases_dot_bf16(out12)
  u8_y12 = u8_uv12 = out12
  from taichi_image_tpu.ops.color import _YUV_M, _YUV_OFFSET
  n, _, hh, wh = u8_y12.shape
  m, off = _YUV_M, _YUV_OFFSET  # applied to the channel-REVERSED vector

  # Y directly per phase (no (N, 4, 3, hh, wh) yuv intermediate);
  # clamp+quantize per phase and interleave as u8 (exact: interleave is
  # pure movement).
  xy = u8_y12.reshape(n, 4, 3, hh, wh).astype(jnp.float32) / 255.0
  b, g, r = xy[:, :, 2], xy[:, :, 1], xy[:, :, 0]
  y_ph = jnp.minimum(1.0, m[0, 0] * b + m[0, 1] * g + m[0, 2] * r
                     + off[0])
  y_u8 = bayer_ops.phases_to_plane(
      jnp.clip(y_ph * 255.0, 0, 255).astype(jnp.uint8))

  # Chroma: the 2x2 block mean is the mean over phases; the matrix is
  # linear so mean-then-matrix == matrix-then-mean (up to f32 rounding,
  # <=1 u8 count) at a quarter of the arithmetic.
  xc = u8_uv12.reshape(n, 4, 3, hh, wh).astype(jnp.float32) / 255.0
  bc, gc, rc = xc[:, :, 2], xc[:, :, 1], xc[:, :, 0]
  mb, mg, mr = (jnp.mean(bc, axis=1), jnp.mean(gc, axis=1),
                jnp.mean(rc, axis=1))
  u = m[1, 0] * mb + m[1, 1] * mg + m[1, 2] * mr + off[1]
  v = m[2, 0] * mb + m[2, 1] * mg + m[2, 2] * mr + off[2]
  # V-then-U plane order quirk (yuv_420.py:62-64)
  uv = jnp.minimum(1.0, jnp.stack([v, u], axis=1))
  uv_u8 = jnp.clip(uv * 255.0, 0, 255).astype(jnp.uint8)
  return y_u8, uv_u8


# Named scopes of the fused step's stages, in pipeline order: a profiler
# trace of the step attributes each device kernel to one of them
# (taichi_image_tpu/utils/stages.py).
STAGES = ("decode", "demosaic", "resize", "meter", "map_max", "finish",
          "i420")


def fused_isp_step(raws, prev, t, gamma, intensity, light_adapt, color_adapt,
                   fmt, ids_format, work_dtype, pattern, cc, resize_plan,
                   stride, transform, tonemap, axis_name=None,
                   n_total=None, color_format="rgb", debug_checks=False):
  """The full per-frame ISP pipeline as a pure function (shardable).

  Returns ``(new_metrics, planar u8 (N, 3, h', w'))``. The pipeline is
  planar throughout (see module note); convert to HWC at the API boundary
  with ``np.moveaxis(out, 1, -1)`` on host, which is a free view.

  ``color_format='yuv420'`` emits planar I420 instead —
  ``(metrics, (Y (N, h', w'), UV (N, 2, h'/2, w'/2)))`` u8 — fusing the
  video-encoder color conversion into the step. It composes with resize
  and output transforms (conversion happens after both, mirroring a
  downstream encoder consuming the reference's transformed RGB output);
  output dims must be even. The no-resize/no-transform case converts
  directly from phase form without materializing interleaved RGB.

  When ``axis_name`` is given the camera batch axis is assumed sharded
  over that mesh axis and metering completes with collectives.

  Each stage runs under a ``jax.named_scope`` (:data:`STAGES`), so a
  profiler trace of the step can be attributed per stage.
  """
  if tonemap not in ("reinhard", "linear"):
    raise ValueError(f"unknown tonemap {tonemap}")
  if color_format not in ("rgb", "yuv420"):
    raise ValueError(f"unknown color_format {color_format!r}")
  with jax.named_scope("decode"):
    phases = load_raw_phases(raws, fmt, work_dtype, ids_format)
  if debug_checks:
    # Compiled-in validation (TAICHI_IMAGE_TPU_DEBUG; the reference's
    # ti.init(debug=True) analogue, SURVEY.md §5). The f16/f32 loader
    # paths are exempt from the range check: the reference's load_16f
    # numeric-cast quirk feeds unnormalized values by design.
    from jax.experimental import checkify
    if fmt in ("packed12", "packed16", "u16"):
      checkify.check(
          (phases.astype(jnp.float32) >= 0.0).all()
          & (phases.astype(jnp.float32) <= 1.0).all(),
          "decoded CFA values escape [0, 1] — corrupt raw or wrong format")
  wd = types.canonical_dtype(work_dtype)
  # Without a resize and with an even stride, full-res stride-s pixels
  # are exactly the phase-(0, 0) channels of x12 at half-res stride s/2:
  # the demosaic hands out that sample grid beside x12.
  want_sample = resize_plan is None and stride % 2 == 0
  with jax.named_scope("demosaic"):
    if want_sample:
      x12, strided_sample = demosaic_phases(
          phases, pattern, cc=cc, out_dtype=wd,
          sample_step=max(stride // 2, 1))
    else:
      x12 = demosaic_phases(phases, pattern, cc=cc, out_dtype=wd)

  def _meter(strided):
    with jax.named_scope("meter"):
      m = metering_update_ca(strided, prev, t, axis_name=axis_name,
                             n_total=n_total)
    if debug_checks:
      from jax.experimental import checkify
      checkify.check(
          jnp.isfinite(m).all(),
          "metering produced non-finite stats — NaN/inf in input frames")
    return m

  def _tonemap(x, new_metrics):
    if tonemap == "linear":
      with jax.named_scope("finish"):
        return linear_apply_ca(x, new_metrics, gamma)
    with jax.named_scope("map_max"):
      cast, max_out = reinhard_map_max_ca(x, new_metrics, intensity,
                                          light_adapt, color_adapt,
                                          work_dtype)
    with jax.named_scope("finish"):
      return reinhard_gamma_ca(cast, max_out, gamma)

  if resize_plan is not None:
    size, scale = resize_plan
    with jax.named_scope("resize"):
      rgb = _resize_from_phases(x12, size, scale, work_dtype)
    # a plain strided slice fuses into the resize producer: XLA computes
    # only the sampled positions
    new_metrics = _meter(rgb[:, :, ::stride, ::stride])
    out = _tonemap(rgb, new_metrics).reshape(rgb.shape)
  elif stride % 2 != 0:
    # odd metering stride: assemble planar first
    rgb = phases_to_planar(x12, wd)
    new_metrics = _meter(subsample_hw(rgb, stride, stride))
    out = _tonemap(rgb, new_metrics).reshape(rgb.shape)
  else:
    n, _, hh, wh = phases.shape
    new_metrics = _meter(strided_sample)
    out12 = _tonemap(x12.reshape(n, 4, 3, hh, wh),
                     new_metrics).reshape(n, 12, hh, wh)
    if color_format == "yuv420":
      # u8 first (one 1-byte phase array read by both I420 chains), then
      # the transform in phase space, then the conversion: no interleaved
      # RGB intermediate
      with jax.named_scope("i420"):
        u8_12 = _transform_phases(out12, transform)
        return new_metrics, yuv420_from_phases_u8(u8_12,
                                                  dot=wd == types.bf16)
    # transform in phase space (see _transform_phases) then interleave
    with jax.named_scope("finish"):
      out = planar_from_phases_transformed(out12, transform)
    transform = ImageTransform.none
  out = _transform_planar(out, transform)
  if color_format == "yuv420":
    with jax.named_scope("i420"):
      return new_metrics, yuv420_from_planar_u8(out)
  return new_metrics, out


_FUSED_STATIC = ("gamma", "intensity", "light_adapt", "color_adapt",
                 "fmt", "ids_format", "work_dtype", "pattern", "cc",
                 "resize_plan", "stride", "transform", "tonemap",
                 "color_format")


@partial(jax.jit, static_argnames=_FUSED_STATIC, donate_argnums=(1,))
def _jit_fused_step(raws, prev, t, gamma, intensity, light_adapt,
                    color_adapt, fmt, ids_format, work_dtype, pattern, cc,
                    resize_plan, stride, transform, tonemap,
                    color_format="rgb"):
  return fused_isp_step(raws, prev, t, gamma, intensity, light_adapt,
                        color_adapt, fmt, ids_format, work_dtype, pattern,
                        cc, resize_plan, stride, transform, tonemap,
                        color_format=color_format)


# Debug variant (TAICHI_IMAGE_TPU_DEBUG=1): compiled-in checkify
# invariants, no donation (checkify threads an error value through).
_jit_fused_step_checked = debug_util.checked_jit(
    partial(fused_isp_step, debug_checks=True),
    static_argnames=_FUSED_STATIC)


def camera_isp(name: str, dtype=types.f32):
  """Class factory closing over a working dtype
  (reference camera_isp.py:75-418)."""
  cls = type(name, (_ISPBase,),
             {"_work_dtype": types.canonical_dtype(dtype)})
  cls.__qualname__ = name
  cls.__module__ = __name__
  # expose the tonemap kernels like the reference (camera_isp.py:415-416)
  cls.reinhard_kernel = staticmethod(reinhard_apply)
  cls.linear_kernel = staticmethod(linear_apply)
  return cls


Camera16 = camera_isp("Camera16", types.f16)
Camera32 = camera_isp("Camera32", types.f32)
# bf16 working dtype (reference has no bf16; SURVEY.md §7 notes
# f16-for-parity / bf16-for-speed)
CameraBF16 = camera_isp("CameraBF16", types.bf16)
