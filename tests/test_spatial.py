"""Spatial (row-sharded) processing tests on the 8-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from taichi_image_tpu import types
from taichi_image_tpu.models.camera_isp import Camera32
from taichi_image_tpu.ops import bayer, packed
from taichi_image_tpu.ops.bayer import cfa_phases, demosaic_phases
from taichi_image_tpu.parallel import spatial
from conftest import make_test_rgb
from oracle import rgb_to_bayer_oracle


def _mesh(n):
  return Mesh(np.array(jax.devices()[:n]), (spatial.ROW_AXIS,))


@pytest.mark.parametrize("n_dev", [2, 4])
def test_spatial_demosaic_matches_single(n_dev):
  img = make_test_rgb(64, 96)
  cfa = rgb_to_bayer_oracle(img, "RGGB")[None]
  phases = cfa_phases(jnp.asarray(cfa)).astype(jnp.float32)

  want = np.asarray(demosaic_phases(phases, bayer.BayerPattern.RGGB))
  mesh = _mesh(n_dev)
  from jax.sharding import NamedSharding, PartitionSpec as P
  sharded = jax.device_put(phases,
                           NamedSharding(mesh, P(None, None,
                                                 spatial.ROW_AXIS, None)))
  got = np.asarray(spatial.demosaic_phases_spatial(
      sharded, mesh, bayer.BayerPattern.RGGB))
  np.testing.assert_allclose(got, want, atol=1e-5)


def test_spatial_demosaic_with_cc():
  img = make_test_rgb(32, 64)
  cfa = rgb_to_bayer_oracle(img, "RGGB")[None]
  phases = cfa_phases(jnp.asarray(cfa)).astype(jnp.float32)
  cc = tuple(np.array([[1.5, -0.2, -0.3], [-0.1, 1.2, -0.1],
                       [0.0, -0.4, 1.4]], np.float32).flatten().tolist())
  want = np.asarray(demosaic_phases(phases, bayer.BayerPattern.RGGB, cc=cc))
  mesh = _mesh(2)
  from jax.sharding import NamedSharding, PartitionSpec as P
  sharded = jax.device_put(phases,
                           NamedSharding(mesh, P(None, None,
                                                 spatial.ROW_AXIS, None)))
  got = np.asarray(spatial.demosaic_phases_spatial(
      sharded, mesh, bayer.BayerPattern.RGGB, cc=cc))
  np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_spatial_isp_step_matches_unsharded(n_dev):
  h, w = 64, 96
  raws = []
  for s in range(2):
    img = make_test_rgb(h, w, seed=s)
    cfa = rgb_to_bayer_oracle(img, "RGGB")
    raws.append(np.asarray(packed.encode12(cfa, scaled=True)))
  raws = np.stack(raws)

  ref = Camera32(bayer.BayerPattern.RGGB, moving_alpha=0.2)
  ref_out = ref.process(raws, gamma=0.8, intensity=2.0)

  mesh = _mesh(n_dev)
  step = spatial.make_spatial_isp_step(
      mesh, work_dtype=types.f32, pattern=bayer.BayerPattern.RGGB,
      n_cameras=2, image_hw=(h, w))
  from jax.sharding import NamedSharding, PartitionSpec as P
  raws_s = jax.device_put(jnp.asarray(raws),
                          NamedSharding(mesh, P(None, spatial.ROW_AXIS)))
  prev = jax.device_put(jnp.zeros(9, jnp.float32),
                        NamedSharding(mesh, P()))
  metrics, out = step(raws_s, prev, jnp.float32(0.0), jnp.float32(0.8),
                      jnp.float32(2.0), jnp.float32(1.0), jnp.float32(0.0))

  np.testing.assert_allclose(np.asarray(metrics), np.asarray(ref.metrics),
                             atol=1e-5)
  diff = np.abs(np.asarray(out).astype(int) -
                np.asarray(ref_out).astype(int))
  assert diff.max() <= 1
  assert (diff > 0).mean() < 0.01


def test_spatial_alignment_asserted():
  # misuse raises ValueError (not bare assert — survives python -O)
  mesh = _mesh(8)
  with pytest.raises(ValueError, match="multiple of 8"):
    spatial.make_spatial_isp_step(
        mesh, work_dtype=types.f32, pattern=bayer.BayerPattern.RGGB,
        n_cameras=1, image_hw=(60, 96))  # 60/8 not multiple of 8


def test_grid_2d_mesh_matches_unsharded():
  """Cameras x rows 2-D mesh (dp x sp) equals the single-device result."""
  h, w = 64, 96
  raws = []
  for s in range(4):
    img = make_test_rgb(h, w, seed=s)
    cfa = rgb_to_bayer_oracle(img, "RGGB")
    raws.append(np.asarray(packed.encode12(cfa, scaled=True)))
  raws = np.stack(raws)

  ref = Camera32(bayer.BayerPattern.RGGB, moving_alpha=0.2)
  ref_out = ref.process(raws, gamma=0.8, intensity=2.0)

  devs = np.array(jax.devices()[:8]).reshape(2, 4)
  mesh = Mesh(devs, ("cam", spatial.ROW_AXIS))
  step = spatial.make_grid_isp_step(
      mesh, work_dtype=types.f32, pattern=bayer.BayerPattern.RGGB,
      n_cameras=4, image_hw=(h, w))
  from jax.sharding import NamedSharding, PartitionSpec as P
  raws_s = jax.device_put(jnp.asarray(raws),
                          NamedSharding(mesh, P("cam", spatial.ROW_AXIS)))
  prev = jax.device_put(jnp.zeros(9, jnp.float32), NamedSharding(mesh, P()))
  metrics, out = step(raws_s, prev, jnp.float32(0.0), jnp.float32(0.8),
                      jnp.float32(2.0), jnp.float32(1.0), jnp.float32(0.0))

  np.testing.assert_allclose(np.asarray(metrics), np.asarray(ref.metrics),
                             atol=1e-5)
  diff = np.abs(np.asarray(out).astype(int) -
                np.asarray(ref_out).astype(int))
  assert diff.max() <= 1
  assert (diff > 0).mean() < 0.01


@pytest.mark.parametrize("n_shards", [2, 3])
def test_demosaic_local_halo_conv_matches_full_conv(rng, n_shards):
  """The per-shard demosaic's rows-VALID conv over a shard padded with
  one neighbour row on each side (zeros past the image edges) equals
  the same rows of the whole image's zero-padded conv."""
  import jax
  import jax.numpy as jnp
  from taichi_image_tpu.ops.bayer import _demosaic_tables
  from taichi_image_tpu.ops.bayer import BayerPattern

  hh_l, wh = 6, 20
  weights = jnp.asarray(_demosaic_tables(BayerPattern.GRBG, "mhc"))
  full = jnp.asarray(rng.random((2, 4, hh_l * n_shards, wh), np.float32))

  def conv(x, rows_pad):
    return jax.lax.conv_general_dilated(
        x, weights, (1, 1), ((rows_pad, rows_pad), (1, 1)),
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)

  want = np.asarray(conv(full, 1))
  padded_full = jnp.pad(full, ((0, 0), (0, 0), (1, 1), (0, 0)))
  for i in range(n_shards):
    shard = padded_full[:, :, i * hh_l:(i + 1) * hh_l + 2]
    got = np.asarray(conv(shard, 0))
    np.testing.assert_allclose(got, want[:, :, i * hh_l:(i + 1) * hh_l],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_spatial_step_with_resize(n_dev):
  """Row-sharded step + in-step resize (round-3): shard-uniform taps +
  halo exchange equal the unsharded fused resize path."""
  h, w = 64, 96
  raws = []
  for s in range(2):
    img = make_test_rgb(h, w, seed=s)
    cfa = rgb_to_bayer_oracle(img, "RGGB")
    raws.append(np.asarray(packed.encode12(cfa, scaled=True)))
  raws = np.stack(raws)

  ref = Camera32(bayer.BayerPattern.RGGB, moving_alpha=0.2, scale=0.5)
  ref_out = ref.process(raws, gamma=0.8, intensity=2.0)

  mesh = _mesh(n_dev)
  step = spatial.make_spatial_isp_step(
      mesh, work_dtype=types.f32, pattern=bayer.BayerPattern.RGGB,
      n_cameras=2, image_hw=(h, w), resize_plan=((48, 32), 0.5))
  from jax.sharding import NamedSharding, PartitionSpec as P
  raws_s = jax.device_put(jnp.asarray(raws),
                          NamedSharding(mesh, P(None, spatial.ROW_AXIS)))
  prev = jax.device_put(jnp.zeros(9, jnp.float32),
                        NamedSharding(mesh, P()))
  metrics, out = step(raws_s, prev, jnp.float32(0.0), jnp.float32(0.8),
                      jnp.float32(2.0), jnp.float32(1.0),
                      jnp.float32(0.0))

  assert np.asarray(out).shape == (2, 3, 32, 48)
  np.testing.assert_allclose(np.asarray(metrics), np.asarray(ref.metrics),
                             atol=1e-5)
  diff = np.abs(np.asarray(out).astype(int) -
                np.asarray(ref_out).astype(int))
  assert diff.max() <= 1
  assert (diff > 0).mean() < 0.01


def test_spatial_step_with_transform():
  """Output transform applied outside the shard_map (GSPMD reshards)."""
  from taichi_image_tpu.ops.interpolate import ImageTransform
  h, w = 64, 96
  img = make_test_rgb(h, w, seed=0)
  cfa = rgb_to_bayer_oracle(img, "RGGB")
  raws = np.stack([np.asarray(packed.encode12(cfa, scaled=True))] * 2)

  ref = Camera32(bayer.BayerPattern.RGGB,
                 transform=ImageTransform.rotate_90)
  ref_out = ref.process(raws, gamma=0.8)

  mesh = _mesh(4)
  step = spatial.make_spatial_isp_step(
      mesh, work_dtype=types.f32, pattern=bayer.BayerPattern.RGGB,
      n_cameras=2, image_hw=(h, w),
      transform=ImageTransform.rotate_90)
  from jax.sharding import NamedSharding, PartitionSpec as P
  raws_s = jax.device_put(jnp.asarray(raws),
                          NamedSharding(mesh, P(None, spatial.ROW_AXIS)))
  prev = jax.device_put(jnp.zeros(9, jnp.float32),
                        NamedSharding(mesh, P()))
  metrics, out = step(raws_s, prev, jnp.float32(0.0), jnp.float32(0.8),
                      jnp.float32(1.0), jnp.float32(1.0),
                      jnp.float32(0.0))
  assert np.asarray(out).shape == np.asarray(ref_out).shape
  diff = np.abs(np.asarray(out).astype(int) -
                np.asarray(ref_out).astype(int))
  assert diff.max() <= 1


def test_grid_step_with_resize():
  h, w = 64, 96
  raws = []
  for s in range(4):
    img = make_test_rgb(h, w, seed=s)
    cfa = rgb_to_bayer_oracle(img, "RGGB")
    raws.append(np.asarray(packed.encode12(cfa, scaled=True)))
  raws = np.stack(raws)

  ref = Camera32(bayer.BayerPattern.RGGB, scale=0.5)
  ref_out = ref.process(raws, gamma=0.8)

  devs = np.array(jax.devices()[:8]).reshape(2, 4)
  mesh = Mesh(devs, ("cam", spatial.ROW_AXIS))
  step = spatial.make_grid_isp_step(
      mesh, work_dtype=types.f32, pattern=bayer.BayerPattern.RGGB,
      n_cameras=4, image_hw=(h, w), resize_plan=((48, 32), 0.5))
  from jax.sharding import NamedSharding, PartitionSpec as P
  raws_s = jax.device_put(jnp.asarray(raws),
                          NamedSharding(mesh, P("cam", spatial.ROW_AXIS)))
  prev = jax.device_put(jnp.zeros(9, jnp.float32), NamedSharding(mesh, P()))
  metrics, out = step(raws_s, prev, jnp.float32(0.0), jnp.float32(0.8),
                      jnp.float32(1.0), jnp.float32(1.0), jnp.float32(0.0))
  np.testing.assert_allclose(np.asarray(metrics), np.asarray(ref.metrics),
                             atol=1e-5)
  diff = np.abs(np.asarray(out).astype(int) -
                np.asarray(ref_out).astype(int))
  assert diff.max() <= 1


def test_spatial_resize_misalignment_raises():
  mesh = _mesh(4)
  # resized height 30 does not divide over 4 shards
  with pytest.raises(ValueError, match="divide"):
    spatial.make_spatial_isp_step(
        mesh, work_dtype=types.f32, pattern=bayer.BayerPattern.RGGB,
        n_cameras=1, image_hw=(96, 128), resize_plan=((40, 30), 0.3125))


def test_spatial_shape_fuzz():
  """Seeded fuzz over the row-sharded step:
  n_dev x dtype x pattern x resize must match the unsharded step."""
  from jax.sharding import NamedSharding, PartitionSpec as P
  rng = np.random.default_rng(11)
  wds = [types.f32, types.f16]
  for trial in range(6):
    n_dev = int(rng.choice([2, 4]))
    n_cam = int(rng.integers(1, 3))
    h = 16 * n_dev * int(rng.integers(1, 3))
    w = 2 * int(rng.integers(24, 56))
    wd = wds[trial % 2]
    pat = list(bayer.BayerPattern)[int(rng.integers(0, 4))]
    resize = None
    if rng.random() < 0.5 and (h // 2) % (n_dev * 8) == 0:
      resize = ((w // 2, h // 2), 0.5)
    elif rng.random() < 0.5:  # integer upscale (replicate-halo path)
      resize = ((w * 2, h * 2), 2.0)
    raws = np.stack([
        rng.integers(0, 256, size=(h, w * 3 // 2), dtype=np.uint8)
        for _ in range(n_cam)])

    from taichi_image_tpu.models.camera_isp import camera_isp
    cls = camera_isp(f"SpFuzz{trial}", wd)
    ref = cls(pat, scale=resize[1] if resize else None)
    ref_out = ref.process(raws, gamma=0.8)

    mesh = _mesh(n_dev)
    step = spatial.make_spatial_isp_step(
        mesh, work_dtype=wd, pattern=pat, n_cameras=n_cam,
        image_hw=(h, w), resize_plan=resize)
    raws_s = jax.device_put(jnp.asarray(raws),
                            NamedSharding(mesh, P(None, spatial.ROW_AXIS)))
    prev = jax.device_put(jnp.zeros(9, jnp.float32),
                          NamedSharding(mesh, P()))
    m, out = step(raws_s, prev, jnp.float32(0.0), jnp.float32(0.8),
                  jnp.float32(1.0), jnp.float32(1.0), jnp.float32(0.0))
    got = np.asarray(out)
    want = np.asarray(ref_out)
    assert got.shape == want.shape, (trial, got.shape, want.shape)
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1, (trial, d.max())
    np.testing.assert_allclose(np.asarray(m), np.asarray(ref.metrics),
                               atol=1e-5)


def _encode_rig(h, w, n_cam):
  raws = []
  for s in range(n_cam):
    img = make_test_rgb(h, w, seed=s)
    cfa = rgb_to_bayer_oracle(img, "RGGB")
    raws.append(np.asarray(packed.encode12(cfa, scaled=True)))
  return np.stack(raws)


def _i420_diff(got, want):
  gy, guv = got
  wy, wuv = want
  return max(np.abs(np.asarray(gy).astype(int)
                    - np.asarray(wy).astype(int)).max(),
             np.abs(np.asarray(guv).astype(int)
                    - np.asarray(wuv).astype(int)).max())


@pytest.mark.parametrize("work", [types.f32, types.bf16])
def test_spatial_step_yuv420(work):
  """Shard-local I420 conversion (2x2 chroma blocks never straddle a
  row-shard boundary) equals the unsharded fused yuv420 step."""
  from taichi_image_tpu.models.camera_isp import camera_isp
  h, w = 64, 96
  raws = _encode_rig(h, w, 2)

  cls = camera_isp(f"SpYuv_{np.dtype(work).name}", work)
  ref = cls(bayer.BayerPattern.RGGB, moving_alpha=0.2)
  ref_out = ref.process(raws, gamma=0.8, intensity=2.0,
                        color_format="yuv420")

  mesh = _mesh(4)
  step = spatial.make_spatial_isp_step(
      mesh, work_dtype=work, pattern=bayer.BayerPattern.RGGB,
      n_cameras=2, image_hw=(h, w), color_format="yuv420")
  from jax.sharding import NamedSharding, PartitionSpec as P
  raws_s = jax.device_put(jnp.asarray(raws),
                          NamedSharding(mesh, P(None, spatial.ROW_AXIS)))
  prev = jax.device_put(jnp.zeros(9, jnp.float32), NamedSharding(mesh, P()))
  metrics, out = step(raws_s, prev, jnp.float32(0.0), jnp.float32(0.8),
                      jnp.float32(2.0), jnp.float32(1.0), jnp.float32(0.0))
  y, uv = out
  assert np.asarray(y).shape == (2, h, w)
  assert np.asarray(uv).shape == (2, 2, h // 2, w // 2)
  np.testing.assert_allclose(np.asarray(metrics), np.asarray(ref.metrics),
                             atol=1e-5)
  assert _i420_diff(out, ref_out) <= 1


def test_spatial_step_yuv420_with_transform():
  """Transform + I420: conversion recomposes OUTSIDE the shard_map on
  the transformed planar output (unsharded-step semantics)."""
  from taichi_image_tpu.ops.interpolate import ImageTransform
  h, w = 64, 96
  raws = _encode_rig(h, w, 2)

  ref = Camera32(bayer.BayerPattern.RGGB,
                 transform=ImageTransform.rotate_90)
  ref_out = ref.process(raws, gamma=0.8, color_format="yuv420")

  mesh = _mesh(4)
  step = spatial.make_spatial_isp_step(
      mesh, work_dtype=types.f32, pattern=bayer.BayerPattern.RGGB,
      n_cameras=2, image_hw=(h, w), transform=ImageTransform.rotate_90,
      color_format="yuv420")
  from jax.sharding import NamedSharding, PartitionSpec as P
  raws_s = jax.device_put(jnp.asarray(raws),
                          NamedSharding(mesh, P(None, spatial.ROW_AXIS)))
  prev = jax.device_put(jnp.zeros(9, jnp.float32), NamedSharding(mesh, P()))
  _, out = step(raws_s, prev, jnp.float32(0.0), jnp.float32(0.8),
                jnp.float32(1.0), jnp.float32(1.0), jnp.float32(0.0))
  y, uv = out
  assert np.asarray(y).shape == (2, w, h)  # rotated
  assert _i420_diff(out, ref_out) <= 1


def test_spatial_step_yuv420_with_resize():
  """In-step resize + shard-local I420 conversion on the resized shard."""
  h, w = 64, 96
  raws = _encode_rig(h, w, 2)

  ref = Camera32(bayer.BayerPattern.RGGB, scale=0.5)
  ref_out = ref.process(raws, gamma=0.8, color_format="yuv420")

  mesh = _mesh(2)
  step = spatial.make_spatial_isp_step(
      mesh, work_dtype=types.f32, pattern=bayer.BayerPattern.RGGB,
      n_cameras=2, image_hw=(h, w), resize_plan=((48, 32), 0.5),
      color_format="yuv420")
  from jax.sharding import NamedSharding, PartitionSpec as P
  raws_s = jax.device_put(jnp.asarray(raws),
                          NamedSharding(mesh, P(None, spatial.ROW_AXIS)))
  prev = jax.device_put(jnp.zeros(9, jnp.float32), NamedSharding(mesh, P()))
  _, out = step(raws_s, prev, jnp.float32(0.0), jnp.float32(0.8),
                jnp.float32(1.0), jnp.float32(1.0), jnp.float32(0.0))
  y, uv = out
  assert np.asarray(y).shape == (2, 32, 48)
  assert np.asarray(uv).shape == (2, 2, 16, 24)
  assert _i420_diff(out, ref_out) <= 1


def test_grid_step_yuv420():
  """2-D cam x rows mesh with shard-local I420 output."""
  h, w = 64, 96
  raws = _encode_rig(h, w, 4)

  ref = Camera32(bayer.BayerPattern.RGGB, moving_alpha=0.2)
  ref_out = ref.process(raws, gamma=0.8, intensity=2.0,
                        color_format="yuv420")

  devs = np.array(jax.devices()[:8]).reshape(2, 4)
  mesh = Mesh(devs, ("cam", spatial.ROW_AXIS))
  step = spatial.make_grid_isp_step(
      mesh, work_dtype=types.f32, pattern=bayer.BayerPattern.RGGB,
      n_cameras=4, image_hw=(h, w), color_format="yuv420")
  from jax.sharding import NamedSharding, PartitionSpec as P
  raws_s = jax.device_put(jnp.asarray(raws),
                          NamedSharding(mesh, P("cam", spatial.ROW_AXIS)))
  prev = jax.device_put(jnp.zeros(9, jnp.float32), NamedSharding(mesh, P()))
  metrics, out = step(raws_s, prev, jnp.float32(0.0), jnp.float32(0.8),
                      jnp.float32(2.0), jnp.float32(1.0), jnp.float32(0.0))
  np.testing.assert_allclose(np.asarray(metrics), np.asarray(ref.metrics),
                             atol=1e-5)
  assert _i420_diff(out, ref_out) <= 1


def test_spatial_bad_color_format_raises():
  mesh = _mesh(2)
  with pytest.raises(ValueError, match="color_format"):
    spatial.make_spatial_isp_step(
        mesh, work_dtype=types.f32, pattern=bayer.BayerPattern.RGGB,
        n_cameras=1, image_hw=(64, 96), color_format="nv12")
  with pytest.raises(ValueError, match="color_format"):
    spatial.make_grid_isp_step(
        Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
             ("cam", spatial.ROW_AXIS)),
        work_dtype=types.f32, pattern=bayer.BayerPattern.RGGB,
        n_cameras=2, image_hw=(64, 96), color_format="nv12")


@pytest.mark.parametrize("n_dev", [2, 4])
def test_spatial_step_with_upscale(n_dev):
  """Integer UPSCALE across row shards (round-3, late): the unclamped
  tap tables are shift-invariant, and the reference's bottom-edge tap
  clamp is reproduced by the last shard's parity-corrected replicate
  halo — matches the unsharded fused upscale within the usual 1 count
  (was a ValueError before; the halo machinery was unreachable)."""
  h, w = 64, 96
  raws = []
  for s in range(2):
    img = make_test_rgb(h, w, seed=s)
    cfa = rgb_to_bayer_oracle(img, "RGGB")
    raws.append(np.asarray(packed.encode12(cfa, scaled=True)))
  raws = np.stack(raws)

  ref = Camera32(bayer.BayerPattern.RGGB, moving_alpha=0.2, scale=2.0)
  ref_out = ref.process(raws, gamma=0.8, intensity=2.0)

  mesh = _mesh(n_dev)
  step = spatial.make_spatial_isp_step(
      mesh, work_dtype=types.f32, pattern=bayer.BayerPattern.RGGB,
      n_cameras=2, image_hw=(h, w), resize_plan=((192, 128), 2.0))
  from jax.sharding import NamedSharding, PartitionSpec as P
  raws_s = jax.device_put(jnp.asarray(raws),
                          NamedSharding(mesh, P(None, spatial.ROW_AXIS)))
  prev = jax.device_put(jnp.zeros(9, jnp.float32),
                        NamedSharding(mesh, P()))
  metrics, out = step(raws_s, prev, jnp.float32(0.0), jnp.float32(0.8),
                      jnp.float32(2.0), jnp.float32(1.0),
                      jnp.float32(0.0))

  assert np.asarray(out).shape == (2, 3, 128, 192)
  np.testing.assert_allclose(np.asarray(metrics), np.asarray(ref.metrics),
                             atol=1e-5)
  diff = np.abs(np.asarray(out).astype(int) -
                np.asarray(ref_out).astype(int))
  assert diff.max() <= 1
  assert (diff > 0).mean() < 0.01
