"""Camera-axis sharding of the fused ISP step over a device mesh.

The reference processes N cameras with a host loop of per-frame kernel
launches on one GPU (camera_isp.py:399-401), sharing one metering state
computed from all frames (camera_isp.py:168-175). The counterpart here
(SURVEY.md §2.9, §7 step 4): cameras are placed along a 1-D ``Mesh`` axis
with ``NamedSharding``; the fused per-frame step runs under ``shard_map``
so each device processes its cameras locally, and the ONE true
collective in the system — the shared exposure metering reduction — is a
pmin/pmax/psum over the camera axis.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from taichi_image_tpu.models.camera_isp import fused_isp_step
from taichi_image_tpu.parallel.runtime import CAMERA_AXIS, make_camera_mesh

__all__ = ["make_camera_mesh", "shard_cameras", "make_sharded_isp_step",
           "replicate"]


def shard_cameras(batch, mesh: Mesh, axis_name: str = CAMERA_AXIS):
  """Place a (n_cameras, ...) batch with the leading axis sharded over the
  mesh's camera axis."""
  return jax.device_put(batch, NamedSharding(mesh, P(axis_name)))


def replicate(x, mesh: Mesh):
  """Replicate an array (e.g. the vec9 metering state) over the mesh."""
  return jax.device_put(x, NamedSharding(mesh, P()))


def make_sharded_isp_step(mesh: Mesh,
                          *,
                          fmt: str = "packed12",
                          ids_format: bool = False,
                          work_dtype,
                          pattern,
                          cc=None,
                          resize_plan=None,
                          stride: int = 8,
                          transform,
                          tonemap: str = "reinhard",
                          n_cameras: int,
                          image_hw,
                          axis_name: str = CAMERA_AXIS):
  """Build the jitted sharded whole-rig step:

      step(raws, prev_metrics, t, gamma, intensity, light_adapt,
           color_adapt) -> (new_metrics, u8 outputs)

  ``raws`` is the (n_cameras, H, W_raw) batch sharded on ``axis_name``;
  ``prev_metrics`` the replicated vec9. ``image_hw`` is the (H, W) of the
  decoded CFA (needed to compute the global strided metering pixel count,
  which must not depend on the local shard shape).
  """
  h, w = image_hw
  if resize_plan is not None:
    (w_out, h_out), _ = resize_plan
  else:
    h_out, w_out = h, w
  hs = -(-h_out // stride)  # ceil: pixels selected by ::stride
  ws = -(-w_out // stride)
  n_total = n_cameras * hs * ws

  def local_step(raws, prev, t, gamma, intensity, light_adapt, color_adapt):
    return fused_isp_step(
        raws, prev, t, gamma, intensity, light_adapt, color_adapt,
        fmt, ids_format, work_dtype, pattern, cc, resize_plan, stride,
        transform, tonemap, axis_name=axis_name, n_total=n_total)

  sharded = jax.shard_map(
      local_step, mesh=mesh,
      in_specs=(P(axis_name), P(), P(), P(), P(), P(), P()),
      out_specs=(P(), P(axis_name)),
      check_vma=False)
  return jax.jit(sharded, donate_argnums=(1,))


def sharded_step_for_isp(isp, mesh: Mesh, raw_shape, fmt: str = "packed12",
                         ids_format: bool = False,
                         tonemap: str = "reinhard",
                         axis_name: str = CAMERA_AXIS):
  """Convenience: derive a sharded step from an ISP instance's config.

  ``raw_shape`` is the global (n_cameras, H, W_raw) shape.
  """
  n, h, w_raw = raw_shape
  w = {"packed12": w_raw * 2 // 3, "packed16": w_raw // 2}.get(fmt, w_raw)
  plan = isp._resize_plan(h, w)
  return make_sharded_isp_step(
      mesh, fmt=fmt, ids_format=ids_format, work_dtype=isp._work_dtype,
      pattern=isp.bayer_pattern, cc=isp._cc_tuple(), resize_plan=plan,
      stride=isp.metering_stride, transform=isp.transform, tonemap=tonemap,
      n_cameras=n, image_hw=(h, w), axis_name=axis_name)
