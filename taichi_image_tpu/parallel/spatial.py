"""Spatial (intra-frame) sharding: split each image's ROWS across devices
with halo exchange at tile borders.

This is the ISP's counterpart of "sequence parallelism"
(SURVEY.md §2.9/§5): one 4K frame fits one device, but larger frames (or
lower latency per frame) split the height axis over the mesh. The 5x5
demosaic stencil needs a 2-pixel halo at full resolution = ONE row of each
half-res phase plane, exchanged with mesh neighbors via ``ppermute``
before the local stencil; metering and the Reinhard per-image max finish
with collectives over the same axis.

Alignment requirements (asserted): rows-per-shard divisible by 8 at full
resolution, so Bayer phase parity and the stride-8 metering grid stay
globally consistent.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from taichi_image_tpu import types
from taichi_image_tpu.models.camera_isp import (_plan_scales,
                                                _resize_from_phases,
                                                _transform_planar,
                                                linear_apply_ca,
                                                metering_update_ca,
                                                reinhard_apply_ca,
                                                yuv420_from_phases_u8,
                                                yuv420_from_planar_u8)
from taichi_image_tpu.ops import bayer as bayer_ops
from taichi_image_tpu.ops.bayer import (_demosaic_tables,
                                        edge_renorm_factor,
                                        phases_to_planar)
from taichi_image_tpu.ops.interpolate import ImageTransform
from taichi_image_tpu.models.camera_isp import load_raw_phases

ROW_AXIS = "rows"

__all__ = ["ROW_AXIS", "shard_rows", "make_spatial_isp_step",
           "demosaic_phases_spatial"]


def shard_rows(batch, mesh: Mesh, axis_name: str = ROW_AXIS):
  """Place a (N, H, ...) image batch with the ROW axis sharded."""
  spec = P(None, axis_name) if batch.ndim >= 2 else P(axis_name)
  return jax.device_put(batch, NamedSharding(mesh, spec))


def _exchange_row_halos(phases, axis_name):
  """1-row halo exchange on (N, 4, hh_local, wh): returns the local
  planes padded to hh_local+2 with neighbor rows (zeros at global ends)."""
  idx = jax.lax.axis_index(axis_name)
  n_shards = jax.lax.axis_size(axis_name)
  top_row = phases[:, :, :1, :]      # my first row -> previous neighbor
  bot_row = phases[:, :, -1:, :]     # my last row  -> next neighbor

  # receive from next neighbor (their first row becomes my bottom halo)
  fwd = [(i, (i - 1) % n_shards) for i in range(n_shards)]
  bottom_halo = jax.lax.ppermute(top_row, axis_name, fwd)
  # receive from previous neighbor (their last row becomes my top halo)
  bwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]
  top_halo = jax.lax.ppermute(bot_row, axis_name, bwd)

  zero = jnp.zeros_like(top_row)
  top_halo = jnp.where(idx == 0, zero, top_halo)
  bottom_halo = jnp.where(idx == n_shards - 1, zero, bottom_halo)
  return jnp.concatenate([top_halo, phases, bottom_halo], axis=2)


def _demosaic_local(phases_local, pattern, cc, method, axis_name):
  """Demosaic a row shard: halo exchange + local stencil + edge renorm
  gated to the GLOBAL top/bottom shards only. The exchanged halo rows
  give the rows-VALID conv its context rows.
  """
  n, _, hh_l, wh = phases_local.shape
  weights = _demosaic_tables(pattern, method)
  padded = _exchange_row_halos(phases_local.astype(jnp.float32), axis_name)

  if hh_l < 3:
    raise ValueError(
        "row shards must have at least 3 half-res rows (got "
        f"{hh_l}; use fewer row shards or larger frames)")
  full = weights.sum(axis=(1, 2, 3))
  num = jax.lax.conv_general_dilated(
      padded, jnp.asarray(weights), (1, 1),
      ((0, 0), (1, 1)),  # rows VALID (halos provide context), cols pad
      dimension_numbers=("NCHW", "OIHW", "NCHW"),
      precision=jax.lax.Precision.HIGHEST,
      preferred_element_type=jnp.float32)
  out = num * jnp.asarray(1.0 / full, jnp.float32)[None, :, None, None]

  idx = jax.lax.axis_index(axis_name)
  n_shards = jax.lax.axis_size(axis_name)
  # row strips fire only at the GLOBAL image edges (gated factors)
  out = out * edge_renorm_factor(weights, hh_l, wh,
                                 is_top=(idx == 0),
                                 is_bot=(idx == n_shards - 1))

  if cc is not None:
    ccm = jnp.asarray(np.array(cc, np.float32).reshape(3, 3))
    x = out.reshape(n, 4, 3, hh_l, wh)
    x = jnp.einsum("npchw,dc->npdhw", x, ccm,
                   precision=jax.lax.Precision.HIGHEST)
    out = x.reshape(n, 12, hh_l, wh)
  return jnp.clip(out, 0.0, 1.0)


def demosaic_phases_spatial(phases, mesh: Mesh, pattern, cc=None,
                            method="mhc", axis_name: str = ROW_AXIS):
  """Demosaic (N, 4, hh, wh) phase planes with hh sharded over
  ``axis_name``: halo exchange between neighbours + local stencil."""
  local = partial(_demosaic_local, pattern=pattern, cc=cc, method=method,
                  axis_name=axis_name)
  f = jax.shard_map(local, mesh=mesh,
                    in_specs=P(None, None, axis_name, None),
                    out_specs=P(None, None, axis_name, None),
                    check_vma=False)
  return jax.jit(f)(phases)


def _spatial_resize_plan(h, w, n_shards, resize_plan, stride):
  """Validate + precompute shard-uniform resize taps for row sharding.

  Every shard runs the SAME program, so shard i must be able to reuse
  shard 0's tap table shifted by i * h_in_local — checked on the
  UNCLAMPED sample positions, which are genuinely shift-invariant for
  the production scales (x0.5, x0.25, integer upscales — dyadic/integer
  factors are exact in the reference's f32 tap arithmetic; non-dyadic
  scales like x0.75 drift in f32 and are rejected); a ValueError names
  the incompatibility otherwise. The reference's bottom-edge tap CLAMP
  (interpolate.py:24-34) is NOT shift-invariant — the last shard's
  clamped rows differ from shard 0's — so it is reproduced instead by
  the bottom halo: the last shard's halo row is a parity-corrected
  REPLICATE of its last row (_exchange_extra_halos), which reads the
  same values the clamp would (bitwise). Returns (size, (sy, sx),
  h_out_local, halo_lo, halo_hi) with halos in PHASE rows."""
  size, scale = resize_plan
  w_out, h_out = size
  sy, sx = _plan_scales(h, w, size, scale)
  if h_out % n_shards:
    raise ValueError(
        f"resized height {h_out} must divide over {n_shards} row shards")
  hol = h_out // n_shards
  if hol % stride:
    raise ValueError(
        f"resized rows per shard ({hol}) must be a multiple of the "
        f"metering stride ({stride}) so the sample grid stays global")
  hil = h // n_shards
  # unclamped positions (p = o/sy, lo = trunc, hi = lo+1 — the clamp is
  # handled by the replicate halo, see docstring)
  p = np.arange(h_out, dtype=np.float32) / np.float32(sy)
  r_lo = p.astype(np.int32)
  r_f = p - r_lo.astype(np.float32)
  r_hi = r_lo + 1
  for i in range(1, n_shards):
    o = slice(i * hol, (i + 1) * hol)
    if (not np.array_equal(r_lo[o], r_lo[:hol] + i * hil)
        or not np.array_equal(r_f[o], r_f[:hol])):
      raise ValueError(
          f"resize scale {sy} is not shift-invariant across {n_shards} "
          f"row shards (f32 tap drift) — use process_large or an "
          f"unsharded step for this scale")
  # shard-local taps reference full-res rows [r_lo[0], r_hi[hol-1]] of
  # the local range [0, hil): halo rows needed beyond it (phase rows)
  halo_lo = max(0, -(-max(0, 0 - int(r_lo[0])) // 2))
  halo_hi = max(0, -(-max(0, int(r_hi[hol - 1]) - (hil - 1)) // 2))
  if halo_lo != 0:
    # _exchange_extra_halos documents (and relies on) halo_lo == 0:
    # truncation-anchored sampling gives r_lo[0] = trunc(0/sy) = 0, so
    # its top-edge branch feeds ZEROS — fine only while never taken. A
    # sampling-convention change (e.g. half-pixel centers) would
    # otherwise silently feed zeros as a real top halo.
    raise ValueError(
        f"resize plan needs a top halo of {halo_lo} phase rows — the "
        "row-sharded resize only supports truncation-anchored sampling "
        "(top tap at row 0); use process_large or an unsharded step")
  return size, (sy, sx), hol, halo_lo, halo_hi


# row-parity-1 counterpart of each 12-channel phase slot: phases are
# ordered (dy, dx) = (0,0), (1,0), (0,1), (1,1) (ops/bayer._PHASE_PARITY)
# so dy=0 slots map to their dy=1 partner (0->1, 2->3), dy=1 to itself
_REPLICATE_PERM = [pm * 3 + c for pm in (1, 1, 3, 3) for c in range(3)]


def _exchange_extra_halos(x12, axis_name, halo_lo, halo_hi):
  """Exchange ``halo_lo`` top / ``halo_hi`` bottom PHASE rows of the
  (N, 12, hh_l, wh) demosaiced shard with mesh neighbors.

  Past the global BOTTOM edge the halo is a parity-corrected REPLICATE
  of the shard's own last phase row (both row-parity channel slots
  carry the dy=1 values — the true last full-res row), which reproduces
  the reference's bottom tap clamp bitwise: the unclamped tap hi = H
  reads exactly what clamp-to-H-1 would. The top edge needs no fill:
  ``r_lo[0] = trunc(0/sy) = 0``, so ``halo_lo`` is always 0
  (asserted at build in make_spatial_isp_step via _spatial_resize_plan)
  and the branch exists only for symmetry with zeros."""
  idx = jax.lax.axis_index(axis_name)
  n_shards = jax.lax.axis_size(axis_name)
  parts = []
  if halo_lo:
    bot = x12[:, :, -halo_lo:, :]
    fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    top_halo = jax.lax.ppermute(bot, axis_name, fwd)
    top_halo = jnp.where(idx == 0, jnp.zeros_like(top_halo), top_halo)
    parts.append(top_halo)
  parts.append(x12)
  if halo_hi:
    top = x12[:, :, :halo_hi, :]
    bwd = [(i, (i - 1) % n_shards) for i in range(n_shards)]
    bot_halo = jax.lax.ppermute(top, axis_name, bwd)
    repl = jnp.broadcast_to(x12[:, jnp.asarray(_REPLICATE_PERM), -1:, :],
                            bot_halo.shape)
    bot_halo = jnp.where(idx == n_shards - 1, repl, bot_halo)
    parts.append(bot_halo)
  return jnp.concatenate(parts, axis=2) if len(parts) > 1 else x12


def make_spatial_isp_step(mesh: Mesh, *, fmt: str = "packed12",
                          ids_format: bool = False, work_dtype,
                          pattern, cc=None, stride: int = 8,
                          tonemap: str = "reinhard",
                          n_cameras: int, image_hw,
                          resize_plan=None,
                          transform: ImageTransform = ImageTransform.none,
                          color_format: str = "rgb",
                          axis_name: str = ROW_AXIS):
  """Whole-rig fused step with each frame's ROWS sharded across devices.

  step(raws, prev, t, gamma, intensity, light_adapt, color_adapt)
    -> (metrics, planar u8 (N, 3, H', W') row-sharded)

  ``raws`` is (N, H, W_raw) with H sharded. Requires H/n_shards % 8 == 0
  (Bayer parity + metering-grid alignment).

  ``resize_plan=(size, scale)`` composes the per-frame resize inside the
  sharded step (round-3): shard-uniform taps are validated at build
  (see _spatial_resize_plan) and tap rows crossing shard boundaries ride
  a ppermute halo exchange of the demosaiced phases.

  ``transform`` != none is applied OUTSIDE the shard_map on the sharded
  output — GSPMD repartitions the permuted array (collectives between
  devices) rather than hand-reversing shard order.

  ``color_format='yuv420'`` returns planar I420 ``(Y (N, H', W') row-
  sharded, UV (N, 2, H'/2, W'/2) row-sharded)`` instead. The 2x2 chroma
  blocks never cross a shard boundary (rows-per-shard % 8 == 0), so with
  ``transform == none`` the conversion runs shard-local inside the
  shard_map (phase form, no interleaved RGB); with a transform it
  recomposes outside on the transformed planar output, matching the
  unsharded step's semantics (camera_isp.fused_isp_step).
  """
  h, w = image_hw
  if color_format not in ("rgb", "yuv420"):
    raise ValueError(f"unknown color_format {color_format!r}")
  local_yuv = (color_format == "yuv420"
               and transform == ImageTransform.none)
  n_shards = np.prod([mesh.shape[a] for a in
                      ([axis_name] if isinstance(axis_name, str)
                       else axis_name)])
  if (h // n_shards) % 8 != 0:
    raise ValueError(
        f"rows per shard must be a multiple of 8 (Bayer parity + "
        f"metering-grid alignment); got H={h} over {n_shards} shards")
  if resize_plan is not None:
    size, syx, hol, halo_lo, halo_hi = _spatial_resize_plan(
        h, w, int(n_shards), resize_plan, stride)
    n_total = n_cameras * -(-size[1] // stride) * -(-size[0] // stride)
  else:
    hs = -(-h // stride)
    ws = -(-w // stride)
    n_total = n_cameras * hs * ws

  local_step = _build_local_step(
      fmt, ids_format, work_dtype, pattern, cc, stride, tonemap, n_total,
      None if resize_plan is None else (size, syx, hol, halo_lo, halo_hi,
                                        h),
      meter_axes=axis_name, row_axis=axis_name,
      color_format="yuv420" if local_yuv else "rgb")

  if local_yuv:
    out_spec = (P(None, axis_name, None),
                P(None, None, axis_name, None))
  else:
    out_spec = P(None, None, axis_name, None)
  sharded = jax.shard_map(
      local_step, mesh=mesh,
      in_specs=(P(None, axis_name), P(), P(), P(), P(), P(), P()),
      out_specs=(P(), out_spec),
      check_vma=False)
  return _finish_output(jax.jit(sharded, donate_argnums=(1,)),
                        transform,
                        to_yuv=(color_format == "yuv420"
                                and not local_yuv))


def _build_local_step(fmt, ids_format, work_dtype, pattern, cc, stride,
                      tonemap, n_total, resize_cfg, meter_axes,
                      row_axis, color_format="rgb"):
  """Shared shard-local step body for the 1-D row and 2-D cam x rows
  factories. ``resize_cfg`` = (size, (sy, sx), h_out_local, halo_lo,
  halo_hi, full_h) or None. ``color_format='yuv420'`` converts shard-
  locally (legal because 2x2 chroma blocks never straddle shards)."""
  dot = types.canonical_dtype(work_dtype) == types.bf16

  def local_step(raws, prev, t, gamma, intensity, light_adapt,
                 color_adapt):
    phases = load_raw_phases(raws, fmt, work_dtype, ids_format)
    x12 = _demosaic_local(phases.astype(jnp.float32), pattern, cc,
                          "mhc", row_axis)
    x12 = types.store_as(x12, work_dtype)
    n, _, hh_l, wh = x12.shape
    if resize_cfg is not None:
      size, syx, hol, halo_lo, halo_hi, full_h = resize_cfg
      x12e = _exchange_extra_halos(x12, row_axis, halo_lo, halo_hi)
      # shard-0 tap table, valid for every shard (shift-invariance
      # checked at build); halo_lo shifts the local phase-row origin
      rgb = _resize_from_phases(x12e, size, syx, work_dtype,
                                row_band=(0, hol, -halo_lo, full_h))
      strided = bayer_ops.subsample_hw(rgb, stride, stride)
      metrics = metering_update_ca(strided, prev, t,
                                   axis_name=meter_axes,
                                   n_total=n_total)
      if tonemap == "reinhard":
        out = reinhard_apply_ca(rgb, metrics, gamma, intensity,
                                light_adapt, color_adapt, work_dtype,
                                axis_name=row_axis)
      else:
        out = linear_apply_ca(rgb, metrics, gamma)
      if color_format == "yuv420":
        return metrics, yuv420_from_planar_u8(out)
      return metrics, out
    strided = bayer_ops.subsample_hw(x12[:, 0:3], stride // 2,
                                     stride // 2)
    metrics = metering_update_ca(strided, prev, t, axis_name=meter_axes,
                                 n_total=n_total)
    if tonemap == "reinhard":
      out12 = reinhard_apply_ca(x12.reshape(n, 4, 3, hh_l, wh), metrics,
                                gamma, intensity, light_adapt,
                                color_adapt, work_dtype,
                                axis_name=row_axis)
    else:
      out12 = linear_apply_ca(x12.reshape(n, 4, 3, hh_l, wh), metrics,
                              gamma)
    if color_format == "yuv420":
      return metrics, yuv420_from_phases_u8(
          out12.reshape(n, 12, hh_l, wh), dot=dot)
    out = phases_to_planar(out12.reshape(n, 12, hh_l, wh))
    return metrics, out

  return local_step


def _finish_output(jitted, transform: ImageTransform, to_yuv=False):
  """Wrap a sharded step with the output transform (and, when the
  transform blocks shard-local conversion, the I420 conversion) applied
  OUTSIDE the shard_map: GSPMD repartitions the permuted array
  (collectives between devices) instead of hand-reversing shard
  order."""
  if transform == ImageTransform.none and not to_yuv:
    return jitted

  @jax.jit
  def finish(out):
    out = _transform_planar(out, transform)
    return yuv420_from_planar_u8(out) if to_yuv else out

  def step_with_finish(raws, prev, t, gamma, intensity, light_adapt,
                       color_adapt):
    metrics, out = jitted(raws, prev, t, gamma, intensity, light_adapt,
                          color_adapt)
    return metrics, finish(out)

  return step_with_finish

def make_grid_isp_step(mesh: Mesh, *, fmt: str = "packed12",
                       ids_format: bool = False, work_dtype,
                       pattern, cc=None, stride: int = 8,
                       tonemap: str = "reinhard",
                       n_cameras: int, image_hw,
                       resize_plan=None,
                       transform: ImageTransform = ImageTransform.none,
                       color_format: str = "rgb",
                       cam_axis: str = "cam",
                       row_axis: str = ROW_AXIS):
  """Whole-rig fused step over a 2-D mesh: cameras on one axis (data
  parallel) x image rows on the other (spatial parallel with halo
  exchange). The metering collectives reduce over BOTH axes; the
  Reinhard per-image max reduces over the row axis only.
  ``resize_plan``/``transform``/``color_format`` compose as in
  :func:`make_spatial_isp_step`.

  step(raws, prev, t, gamma, intensity, light_adapt, color_adapt)
    -> (metrics, planar u8 (N, 3, H', W') sharded (cam=N axis,
       rows=H axis))
  """
  h, w = image_hw
  if color_format not in ("rgb", "yuv420"):
    raise ValueError(f"unknown color_format {color_format!r}")
  local_yuv = (color_format == "yuv420"
               and transform == ImageTransform.none)
  n_row_shards = mesh.shape[row_axis]
  if (h // n_row_shards) % 8 != 0:
    raise ValueError(
        f"rows per shard must be a multiple of 8 (Bayer parity + "
        f"metering-grid alignment); got H={h} over {n_row_shards} shards")
  if resize_plan is not None:
    size, syx, hol, halo_lo, halo_hi = _spatial_resize_plan(
        h, w, int(n_row_shards), resize_plan, stride)
    n_total = n_cameras * -(-size[1] // stride) * -(-size[0] // stride)
    resize_cfg = (size, syx, hol, halo_lo, halo_hi, h)
  else:
    n_total = n_cameras * -(-h // stride) * -(-w // stride)
    resize_cfg = None

  local_step = _build_local_step(
      fmt, ids_format, work_dtype, pattern, cc, stride, tonemap, n_total,
      resize_cfg, meter_axes=(cam_axis, row_axis), row_axis=row_axis,
      color_format="yuv420" if local_yuv else "rgb")

  if local_yuv:
    out_spec = (P(cam_axis, row_axis, None),
                P(cam_axis, None, row_axis, None))
  else:
    out_spec = P(cam_axis, None, row_axis, None)
  sharded = jax.shard_map(
      local_step, mesh=mesh,
      in_specs=(P(cam_axis, row_axis), P(), P(), P(), P(), P(), P()),
      out_specs=(P(), out_spec),
      check_vma=False)
  return _finish_output(jax.jit(sharded, donate_argnums=(1,)),
                        transform,
                        to_yuv=(color_format == "yuv420"
                                and not local_yuv))
