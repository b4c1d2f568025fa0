"""Large-frame (e.g. 8K) ISP: sequential row-band drivers.

The reference processes any frame that fits GPU memory
(camera_isp.py:333-340 takes arbitrary HxW), and so does
``ISP.process``. These drivers run the same pipeline as a sequence of
jitted ROW-BAND programs, which bounds each program's working set, with
the 1-phase-row demosaic halo overlapped between bands and the
metering/tonemap global reductions staged across bands:

  stage A  per band: decode + demosaic (+CCM)  -> x12 band (work dtype)
           + the band's stride-aligned metering sample (tiny)
  stage B  once: EMA metering over the concatenated samples — identical
           numbers to the unbanded step (band starts are aligned to the
           metering grid)
  stage C  per band: Reinhard map -> p band (work dtype) + band max
  stage D  once: per-image max over band maxes
  stage E  per band: gamma + u8 + interleave (or I420 conversion)

Band shapes repeat, so each stage compiles once (stage A twice more for
the first/last band's edge-renorm gating). Outputs match the unbanded
``fused_isp_step`` within 1 u8 count on a tiny fraction of pixels (the
staged metering reduction is a separately-compiled program whose f32
summation associates differently — metrics agree to the last ulp;
tests/test_large.py pins this contract).

Two drivers: a ``lax.scan`` single-program band form
(``_banded_scan_step``) and a Python band LOOP (any shape, composes with
the resize policy). ``driver="auto"`` prefers scan > loop; both give
BITWISE-equal outputs (see ``process_banded``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from taichi_image_tpu import types
from taichi_image_tpu.models.camera_isp import (_plan_scales,
                                                _resize_from_phases,
                                                _transform_planar,
                                                decoded_width,
                                                linear_apply_ca,
                                                load_raw_phases,
                                                metering_update_ca,
                                                reinhard_gamma_ca,
                                                reinhard_map_ca,
                                                yuv420_from_phases_u8,
                                                yuv420_from_planar_u8)
from taichi_image_tpu.ops.bayer import (_demosaic_tables,
                                        edge_renorm_factor,
                                        phases_to_planar_stack, subsample_hw)
from taichi_image_tpu.ops.interpolate import ImageTransform, _axis_samples

__all__ = ["process_banded", "band_plan", "band_plan_rows",
           "scan_band_size"]


def scan_band_size(n_rows: int, n_bands: int, q: int):
  """Equal-band size for the lax.scan driver: the largest multiple of
  ``q`` that DIVIDES ``n_rows`` and does not exceed the loop driver's
  band size for the same ``n_bands`` (so compile size stays in the same
  class). None when no such divisor exists (odd row counts — the
  Python-loop driver handles those)."""
  if n_rows < q or n_rows % q:
    return None
  nb = max(1, min(n_bands, n_rows // q))
  per = (-(-n_rows // nb) + q - 1) // q * q
  best = None
  for cand in range(q, min(per, n_rows) + 1, q):
    if n_rows % cand == 0:
      best = cand
  return best


def band_plan_rows(n_rows: int, n_bands: int, q: int,
                   q_fallback: int = None):
  """Split ``n_rows`` into ``<= n_bands`` bands whose starts are
  multiples of ``q`` (or ``q_fallback`` when fewer than ``q`` rows
  exist; a single band when even that doesn't fit). Returns
  [(r0, r1), ...]."""
  if n_rows < q:
    q = q_fallback if q_fallback else 1
    if n_rows < q:
      return [(0, n_rows)]
  n_bands = max(1, min(n_bands, n_rows // q))
  per = (-(-n_rows // n_bands) + q - 1) // q * q  # round band size to q
  edges = []
  r = 0
  while r < n_rows:
    edges.append((r, min(r + per, n_rows)))
    r += per
  return edges


def band_plan(hh: int, n_bands: int, stride: int = 8):
  """Split hh half-res rows into bands whose starts align to the
  half-res metering grid (stride//2). Band sizes quantize to
  lcm(stride//2, 16), which keeps the number of distinct band shapes
  (one compile each) small. Returns [(r0, r1), ...]."""
  return band_plan_rows(hh, n_bands,
                        int(np.lcm(max(stride // 2, 1), 16)),
                        q_fallback=max(stride // 2, 1))


def _band_numerators(phases, weights):
  """(N, 4, hb+2, wh) halo'd phases -> (N, 12, hb, wh) f32
  interior-normalized demosaic numerators: the rows-VALID conv (the halo
  provides the context rows)."""
  num = jax.lax.conv_general_dilated(
      phases.astype(jnp.float32), jnp.asarray(weights), (1, 1),
      ((0, 0), (1, 1)),  # rows VALID (halo provides context), cols pad
      dimension_numbers=("NCHW", "OIHW", "NCHW"),
      precision=jax.lax.Precision.HIGHEST,
      preferred_element_type=jnp.float32)
  full = weights.sum(axis=(1, 2, 3))
  return num * jnp.asarray(1.0 / full, jnp.float32)[None, :, None, None]


def _band_finish_xla(out, weights, cc, wd, is_top, is_bot):
  """Band finish: gated edge renorm (``is_top``/``is_bot`` may be
  Python bools or traced scalars) + optional CCM + clip + cast — the
  same arithmetic demosaic_phases applies."""
  n, _, hb, wh = out.shape
  out = out * edge_renorm_factor(weights, hb, wh, is_top=is_top,
                                 is_bot=is_bot)
  if cc is not None:
    ccm = jnp.asarray(np.array(cc, np.float32).reshape(3, 3))
    x = out.reshape(n, 4, 3, hb, wh)
    x = jnp.einsum("npchw,dc->npdhw", x, ccm,
                   precision=jax.lax.Precision.HIGHEST)
    out = x.reshape(n, 12, hb, wh)
  return types.store_as(jnp.clip(out, 0.0, 1.0), wd)


@partial(jax.jit, static_argnames=("fmt", "ids_format", "work_dtype",
                                   "pattern", "cc", "stride", "is_top",
                                   "is_bot", "emit_sample"))
def _band_demosaic(raw_band, fmt, ids_format, work_dtype, pattern, cc,
                   stride, is_top, is_bot, emit_sample=True):
  """Decode + demosaic one band. ``raw_band`` covers the band's full-res
  rows plus one phase row (2 full-res rows) of halo on each side (zeros
  at the true image edges — drop-tap semantics via the gated edge
  factors)."""
  wd = types.canonical_dtype(work_dtype)
  phases = load_raw_phases(raw_band, fmt, work_dtype, ids_format)
  weights = _demosaic_tables(pattern, "mhc")
  x12 = _band_finish_xla(_band_numerators(phases, weights), weights, cc,
                         wd, is_top, is_bot)
  if not emit_sample:  # resize mode meters the RESIZED rgb instead
    return x12
  sq = max(stride // 2, 1)
  sample = subsample_hw(x12[:, 0:3], sq, sq)
  return x12, sample


@partial(jax.jit, donate_argnums=(1,))
def _jit_metering_bands(samples, prev, t, n_total):
  return metering_update_ca(samples, prev, t, n_total=n_total)


@partial(jax.jit, static_argnames=("intensity", "light_adapt",
                                   "color_adapt", "work_dtype"),
         donate_argnums=(0,))
def _band_reinhard_map(x, metrics, intensity, light_adapt, color_adapt,
                       work_dtype):
  """Reinhard map + band max on a (N, C, hb, w) band — C is 12
  (phase-RGB, no-resize mode) or 3 (planar RGB, resize mode)."""
  n, nc, hb, wh = x.shape
  p = reinhard_map_ca(x.reshape(n, nc // 3, 3, hb, wh), metrics,
                      intensity, light_adapt, color_adapt)
  band_max = jnp.max(p, axis=tuple(range(1, p.ndim))).reshape(n, 1, 1, 1)
  return (types.store_as(p, work_dtype).reshape(n, nc, hb, wh),
          band_max)


@partial(jax.jit, static_argnames=("gamma", "color_format"))
def _band_reinhard_gamma(p_cast, max_out, gamma, color_format):
  # no donation: the only output is u8 (half/quarter the input's bytes)
  # so aliasing can never apply
  n, q, hb, wh = p_cast.shape[0], 12, p_cast.shape[-2], p_cast.shape[-1]
  dot = p_cast.dtype == jnp.bfloat16  # same gate as the unbanded step
  out12 = reinhard_gamma_ca(p_cast, max_out, gamma).reshape(n, q, hb, wh)
  if color_format == "yuv420":
    return yuv420_from_phases_u8(out12, dot=dot)
  return phases_to_planar_stack(out12)


@partial(jax.jit, static_argnames=("size", "scale", "work_dtype",
                                   "row_band", "stride"))
def _band_resize(x12, size, scale, work_dtype, row_band, stride):
  """Resize one demosaiced band to its output rows (global taps via
  ``row_band``, see _resize_from_phases) + the band's metering sample
  (reshape-select: the band rgb is materialized here).

  No donation: the rgb output is 3-channel at the resized extent and
  can never alias the 12-channel phase input."""
  rgb = _resize_from_phases(x12, size, scale, work_dtype,
                            row_band=row_band)
  return rgb, subsample_hw(rgb[:, 0:3], stride, stride)


@partial(jax.jit, static_argnames=("gamma",))
def _band_reinhard_gamma_planar(p_cast, max_out, gamma):
  # no donation: u8 output cannot alias the working-dtype input
  return reinhard_gamma_ca(p_cast, max_out, gamma)


@partial(jax.jit, static_argnames=("gamma",))
def _band_linear_planar(x, metrics, gamma):
  # no donation: u8 output cannot alias the working-dtype input
  return linear_apply_ca(x, metrics, gamma)


@partial(jax.jit, static_argnames=("transform",), donate_argnums=(0,))
def _jit_transform_assembled(out, transform):
  return _transform_planar(out, transform)


@jax.jit
def _jit_yuv_assembled(out):
  return yuv420_from_planar_u8(out)


@partial(jax.jit, static_argnames=("gamma", "color_format"))
def _band_linear(x12, metrics, gamma, color_format):
  # no donation: u8 output cannot alias the working-dtype input
  n, q, hb, wh = x12.shape
  dot = x12.dtype == jnp.bfloat16  # same gate as the unbanded step
  out12 = linear_apply_ca(x12.reshape(n, 4, 3, hb, wh),
                          metrics, gamma).reshape(n, q, hb, wh)
  if color_format == "yuv420":
    return yuv420_from_phases_u8(out12, dot=dot)
  return phases_to_planar_stack(out12)


@partial(jax.jit, static_argnames=("b", "fmt", "ids_format",
                                   "work_dtype", "pattern", "cc",
                                   "stride", "intensity",
                                   "light_adapt", "color_adapt",
                                   "tonemap"))
def _banded_scan_step(raws, prev, t, b, fmt, ids_format, work_dtype,
                      pattern, cc, stride, intensity, light_adapt,
                      color_adapt, tonemap):
  """The banded pipeline through the Reinhard map as ONE program: two
  ``lax.scan`` loops over equal row bands (decode + demosaic + samples
  -> map) around the global reductions (EMA metering, per-image max).
  Returns (metrics, merged working-dtype phase form (N, 12, hh, wh),
  max_out); the gamma/u8 + interleave/yuv finish runs in
  ``_banded_scan_finish_chunk`` programs. Per-op size stays band-sized
  and the set costs ~5 programs instead of the loop driver's
  ~3×n_bands. Values are BITWISE-equal to the loop driver
  (tests/test_large.py)."""
  wd = types.canonical_dtype(work_dtype)
  n, h, wb = raws.shape
  w = decoded_width(fmt, wb)
  hh, wh = h // 2, w // 2
  nb = hh // b
  sq = max(stride // 2, 1)
  weights = _demosaic_tables(pattern, "mhc")

  # one phase row (= 2 full-res raw rows) of halo; zeros at image edges
  raws_p = jnp.pad(raws, ((0, 0), (2, 2), (0, 0)))

  def body_demosaic(_, i):
    raw_band = jax.lax.dynamic_slice_in_dim(raws_p, 2 * b * i,
                                            2 * b + 4, axis=1)
    phases = load_raw_phases(raw_band, fmt, work_dtype, ids_format)
    # edge gates are TRACED per band index — _band_finish_xla /
    # edge_renorm_factor accept traced scalars (the spatial-sharding
    # path uses the same form)
    x12 = _band_finish_xla(_band_numerators(phases, weights), weights,
                           cc, wd, is_top=(i == 0), is_bot=(i == nb - 1))
    return 0, (x12, subsample_hw(x12[:, 0:3], sq, sq))

  _, (x12_b, samp_b) = jax.lax.scan(body_demosaic, 0, jnp.arange(nb))

  # (nb, n, 3, hs, ws) -> (n, 3, nb*hs, ws): same sample values/order
  # as the loop driver's per-band concatenate
  samples = jnp.moveaxis(samp_b, 0, 2)
  samples = samples.reshape(n, 3, -1, samples.shape[-1])
  n_total = samples.shape[0] * samples.shape[2] * samples.shape[3]
  metrics = metering_update_ca(samples, prev, t, n_total=n_total)

  # The band merge back to the full phase form is ONE transpose (XLA
  # folds it into the finish program's consumers).
  def _merge(bands):
    return jnp.moveaxis(bands, 0, 2).reshape(n, 12, hh, wh)

  if tonemap == "linear":
    return metrics, _merge(x12_b), jnp.zeros((n, 1, 1, 1), jnp.float32)

  def body_map(_, x):
    p = reinhard_map_ca(x.reshape(n, 4, 3, b, wh), metrics, intensity,
                        light_adapt, color_adapt)
    band_max = jnp.max(p, axis=tuple(range(1,
                                           p.ndim))).reshape(n, 1, 1, 1)
    return 0, (types.store_as(p, wd).reshape(n, 12, b, wh), band_max)

  _, (p_b, mx_b) = jax.lax.scan(body_map, 0, x12_b)
  return metrics, _merge(p_b), jnp.max(mx_b, axis=0)


# Largest phase-row extent of one finish program: the scan driver's
# gamma + interleave finish runs in 4K-class row chunks, so its working
# set stays bounded like the bands'.
_FINISH_CHUNK_ROWS = 1088


@partial(jax.jit, static_argnames=("tonemap", "gamma", "band_fmt",
                                   "dot", "r0", "r1"))
def _banded_scan_finish_chunk(merged, metrics, max_out, tonemap, gamma,
                              band_fmt, dot, r0, r1):
  """Gamma/u8 quantization + interleave (or phase-form I420) for phase
  rows [r0, r1) of the scan driver's merged working-dtype output, as
  its own program of at most ``_FINISH_CHUNK_ROWS`` rows. The gamma
  stays fused with the interleave (no materialized u8 in between).
  Chunk boundaries are phase rows, so 2x2 chroma blocks never straddle
  a chunk."""
  n, _, _, wh = merged.shape
  chunk = merged[:, :, r0:r1]
  if tonemap == "linear":
    out12 = linear_apply_ca(chunk.reshape(n, 4, 3, r1 - r0, wh), metrics,
                            gamma).reshape(n, 12, r1 - r0, wh)
  else:
    out12 = reinhard_gamma_ca(chunk, max_out,
                              gamma).reshape(n, 12, r1 - r0, wh)
  if band_fmt == "yuv420":  # no-transform fast path: phase-form convert
    return yuv420_from_phases_u8(out12, dot=dot)
  return phases_to_planar_stack(out12)


def process_banded(raws, prev, t, *, n_bands, fmt="packed12",
                   ids_format=False, work_dtype, pattern, cc=None,
                   stride=8, gamma=1.0, intensity=1.0, light_adapt=1.0,
                   color_adapt=0.0, tonemap="reinhard",
                   color_format="rgb", resize_plan=None,
                   transform=ImageTransform.none, driver="auto"):
  """Run the fused ISP pipeline over ``n_bands`` sequential row bands.

  Same arguments/semantics as ``fused_isp_step``. Returns
  ``(metrics, planar u8 (N, 3, H', W'))`` or the I420 pair for
  ``color_format='yuv420'``.

  ``resize_plan=(size, scale)`` composes the per-frame resize with the
  banding (reference applies the resize policy to any frame size,
  camera_isp.py:302-315): bands partition the OUTPUT rows
  (stride-aligned starts so the metering grid matches the unbanded
  step), and each band demosaics exactly the input rows its bilinear
  taps touch (plus the demosaic halo) before resizing with GLOBAL tap
  positions — bitwise the same rows the unbanded resize produces.
  Metering then runs on the resized bands, as in the fused step.

  ``transform`` recomposes on the assembled output (one planar u8
  permutation program at output size — band-local transforms would
  reorder the band layout itself).

  ``driver``: "auto" takes the lax.scan single-program band driver when
  equal stride-aligned bands of the loop driver's size class exist and
  there is no resize, else the Python band loop; "scan"/"loop" force a
  form. Both produce BITWISE-equal outputs.
  """
  if tonemap not in ("reinhard", "linear"):
    raise ValueError(f"unknown tonemap {tonemap}")
  if color_format not in ("rgb", "yuv420"):
    raise ValueError(f"unknown color_format {color_format!r}")
  if stride % 2 != 0:
    raise ValueError("banded processing needs an even metering stride")
  if driver not in ("auto", "loop", "scan"):
    raise ValueError(f"unknown driver {driver!r}")
  raws = jnp.asarray(raws)
  h = raws.shape[-2]
  wd = types.canonical_dtype(work_dtype)
  # per-band conversion only on the no-resize/no-transform phase path;
  # otherwise bands stay planar RGB and convert on the assembled output
  band_fmt = (color_format if (resize_plan is None
                               and transform == ImageTransform.none)
              else "rgb")

  if driver != "loop" and resize_plan is None:
    q = int(np.lcm(max(stride // 2, 1), 16))
    b_scan = scan_band_size(h // 2, n_bands, q)
    # auto only takes scan when its equal bands are in the loop driver's
    # size class: divisor-poor row counts (e.g. hh = 16 * prime) admit
    # only tiny equal bands, and a 100+-iteration scan of slivers loses
    # to the loop's few full bands ("scan" forces it regardless)
    loop_band_max = max(r1 - r0 for r0, r1 in band_plan(h // 2, n_bands,
                                                         stride))
    if (driver == "auto" and b_scan is not None
        and 2 * b_scan < loop_band_max):
      b_scan = None
    if b_scan is not None:
      prev = jnp.array(np.asarray(prev), jnp.float32)
      metrics, merged, max_out = _banded_scan_step(
          raws, prev, jnp.float32(t), b_scan, fmt, ids_format, wd,
          pattern, cc, stride, float(intensity),
          float(light_adapt), float(color_adapt), tonemap)
      chunks = band_plan_rows(h // 2, -(-(h // 2) // _FINISH_CHUNK_ROWS),
                              1)
      outs = [_banded_scan_finish_chunk(merged, metrics, max_out, tonemap,
                                        float(gamma), band_fmt,
                                        wd == types.bf16, r0, r1)
              for (r0, r1) in chunks]
      return _assemble(outs, metrics, band_fmt, transform, color_format)
  if driver == "scan":
    raise ValueError(
        "scan driver needs equal aligned bands and no resize_plan — "
        f"no equal-band plan for {h // 2} half-res rows "
        f"(q={int(np.lcm(max(stride // 2, 1), 16))}) or resize set; "
        "use driver='auto' or 'loop'")

  # one phase row (= 2 full-res raw rows) of halo; zeros at image edges
  raws_p = jnp.pad(raws, ((0, 0), (2, 2), (0, 0)))

  bands_x, samples = [], []
  if resize_plan is None:
    bands = band_plan(h // 2, n_bands, stride)
    for i, (r0, r1) in enumerate(bands):
      raw_band = raws_p[:, 2 * r0:2 * r1 + 4]
      x12, sample = _band_demosaic(
          raw_band, fmt, ids_format, wd, pattern, cc, stride,
          is_top=(i == 0), is_bot=(i == len(bands) - 1))
      bands_x.append(x12)
      samples.append(sample)
  else:
    size, scale = resize_plan
    w = decoded_width(fmt, raws.shape[-1])
    sy, sx = _plan_scales(h, w, size, scale)
    r_lo, r_hi, _ = _axis_samples(size[1], h, sy)
    hh = h // 2
    obands = band_plan_rows(size[1], n_bands, int(np.lcm(stride, 16)),
                            q_fallback=stride)
    for (o0, o1) in obands:
      p0 = int(r_lo[o0]) // 2
      p1 = min(int(r_hi[o1 - 1]) // 2 + 1, hh)
      raw_band = raws_p[:, 2 * p0:2 * p1 + 4]
      x12 = _band_demosaic(
          raw_band, fmt, ids_format, wd, pattern, cc, stride,
          is_top=(p0 == 0), is_bot=(p1 == hh), emit_sample=False)
      rgb, sample = _band_resize(x12, size, (sy, sx), wd,
                                 (o0, o1, p0, h), stride)
      bands_x.append(rgb)
      samples.append(sample)

  sample_all = jnp.concatenate(samples, axis=2)
  n_total = (sample_all.shape[0] * sample_all.shape[2]
             * sample_all.shape[3])
  prev = jnp.array(np.asarray(prev), jnp.float32)  # fresh donatable copy
  metrics = _jit_metering_bands(sample_all, prev, jnp.float32(t),
                                n_total)

  phase_form = resize_plan is None
  outs = []
  if tonemap == "linear":
    for x in bands_x:
      if phase_form:
        outs.append(_band_linear(x, metrics, float(gamma), band_fmt))
      else:
        outs.append(_band_linear_planar(x, metrics, float(gamma)))
  else:
    p_bands, maxes = [], []
    for x in bands_x:
      p_cast, band_max = _band_reinhard_map(
          x, metrics, float(intensity), float(light_adapt),
          float(color_adapt), wd)
      p_bands.append(p_cast)
      maxes.append(band_max)
    max_out = jnp.max(jnp.stack(maxes), axis=0)
    for p_cast in p_bands:
      if phase_form:
        outs.append(_band_reinhard_gamma(p_cast, max_out, float(gamma),
                                         band_fmt))
      else:
        outs.append(_band_reinhard_gamma_planar(p_cast, max_out,
                                                float(gamma)))
  return _assemble(outs, metrics, band_fmt, transform, color_format)


def _assemble(outs, metrics, band_fmt, transform, color_format):
  """Concatenate per-band (or per-chunk) outputs along rows, then apply
  the assembled-output transform / color conversion."""
  if band_fmt == "yuv420":  # per-band phase-form conversion fast path
    y = jnp.concatenate([o[0] for o in outs], axis=1)
    uv = jnp.concatenate([o[1] for o in outs], axis=2)
    return metrics, (y, uv)
  out = jnp.concatenate(outs, axis=2) if len(outs) > 1 else outs[0]
  if transform != ImageTransform.none:
    out = _jit_transform_assembled(out, transform)
  if color_format == "yuv420":
    return metrics, _jit_yuv_assembled(out)
  return metrics, out
