"""Multi-chip sharding tests on the 8-device virtual CPU mesh
(SURVEY.md §4: camera sharding + the metering collective in CI without
accelerators)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from taichi_image_tpu import types
from taichi_image_tpu.models.camera_isp import Camera32
from taichi_image_tpu.ops import bayer, packed
from taichi_image_tpu.ops.interpolate import ImageTransform
from taichi_image_tpu.parallel import (
    make_camera_mesh, replicate, shard_cameras, sharded_step_for_isp)
from conftest import make_test_rgb
from oracle import rgb_to_bayer_oracle


def _raws(n, h=64, w=96):
  raws = []
  for s in range(n):
    img = make_test_rgb(h, w, seed=s)
    cfa = rgb_to_bayer_oracle(img, "RGGB")
    raws.append(np.asarray(packed.encode12(cfa, scaled=True)))
  return np.stack(raws)


def test_eight_virtual_devices():
  assert len(jax.devices()) == 8


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_step_matches_single_device(n_dev):
  n_cam = 8
  raws = _raws(n_cam)
  mesh = make_camera_mesh(n_dev)

  isp = Camera32(bayer.BayerPattern.RGGB, moving_alpha=0.2)
  step = sharded_step_for_isp(isp, mesh, raws.shape)

  prev = replicate(jnp.zeros(9, jnp.float32), mesh)
  raws_sharded = shard_cameras(jnp.asarray(raws), mesh)
  metrics, out = step(raws_sharded, prev, jnp.float32(0.0),
                      jnp.float32(0.8), jnp.float32(2.0), jnp.float32(1.0),
                      jnp.float32(0.0))

  # single-device reference via the fused unsharded path
  ref_isp = Camera32(bayer.BayerPattern.RGGB, moving_alpha=0.2)
  ref_out = ref_isp.process(raws, gamma=0.8, intensity=2.0)

  np.testing.assert_allclose(np.asarray(metrics),
                             np.asarray(ref_isp.metrics), atol=1e-5)
  diff = np.abs(np.asarray(out).astype(int) -
                np.asarray(ref_out).astype(int))
  assert diff.max() <= 1


def test_sharded_ema_second_step():
  n_cam = 4
  raws = _raws(n_cam)
  mesh = make_camera_mesh(4)
  isp = Camera32(bayer.BayerPattern.RGGB, moving_alpha=0.3)
  step = sharded_step_for_isp(isp, mesh, raws.shape)

  prev = replicate(jnp.zeros(9, jnp.float32), mesh)
  raws_s = shard_cameras(jnp.asarray(raws), mesh)
  m1, _ = step(raws_s, prev, jnp.float32(0.0), jnp.float32(1.0),
               jnp.float32(1.0), jnp.float32(1.0), jnp.float32(0.0))
  m2, out2 = step(raws_s, m1, jnp.float32(0.7), jnp.float32(1.0),
                  jnp.float32(1.0), jnp.float32(1.0), jnp.float32(0.0))

  ref = Camera32(bayer.BayerPattern.RGGB, moving_alpha=0.3)
  ref.process(raws)
  ref_out2 = ref.process(raws)
  np.testing.assert_allclose(np.asarray(m2), np.asarray(ref.metrics),
                             atol=1e-5)
  assert np.abs(np.asarray(out2).astype(int) -
                np.asarray(ref_out2).astype(int)).max() <= 1


def test_sharded_with_resize_transform():
  raws = _raws(4)
  mesh = make_camera_mesh(4)
  isp = Camera32(bayer.BayerPattern.RGGB, resize_width=48,
                 transform=ImageTransform.rotate_90)
  step = sharded_step_for_isp(isp, mesh, raws.shape)
  prev = replicate(jnp.zeros(9, jnp.float32), mesh)
  m, out = step(shard_cameras(jnp.asarray(raws), mesh), prev,
                jnp.float32(0.0), jnp.float32(1.0), jnp.float32(1.0),
                jnp.float32(1.0), jnp.float32(0.0))
  assert out.shape == (4, 3, 48, 32)


def test_output_sharding_layout():
  raws = _raws(8)
  mesh = make_camera_mesh(8)
  isp = Camera32(bayer.BayerPattern.RGGB)
  step = sharded_step_for_isp(isp, mesh, raws.shape)
  prev = replicate(jnp.zeros(9, jnp.float32), mesh)
  m, out = step(shard_cameras(jnp.asarray(raws), mesh), prev,
                jnp.float32(0.0), jnp.float32(1.0), jnp.float32(1.0),
                jnp.float32(1.0), jnp.float32(0.0))
  # outputs stay sharded over cameras; metering is replicated
  assert len(out.sharding.device_set) == 8
  assert len(m.sharding.device_set) == 8


def test_dispatch_queue():
  from taichi_image_tpu.parallel import DispatchQueue, dispatch_queue, queued
  with dispatch_queue(threaded=True):
    f = queued(lambda a, b: a + b)
    assert f(2, 3) == 5
    fut = DispatchQueue.run_async(lambda: 42)
    assert fut.result() == 42
  # context manager stopped it
  assert DispatchQueue.executor is None


def test_dispatch_queue_inline():
  from taichi_image_tpu.parallel import DispatchQueue
  DispatchQueue.init()
  try:
    assert DispatchQueue.run_sync(lambda x: x * 2, 21) == 42
  finally:
    DispatchQueue.stop()


def test_sharded_linear_tonemap():
  raws = _raws(4)
  mesh = make_camera_mesh(4)
  isp = Camera32(bayer.BayerPattern.RGGB, moving_alpha=0.2)
  step = sharded_step_for_isp(isp, mesh, raws.shape, tonemap="linear")
  prev = replicate(jnp.zeros(9, jnp.float32), mesh)
  m, out = step(shard_cameras(jnp.asarray(raws), mesh), prev,
                jnp.float32(0.0), jnp.float32(0.8), jnp.float32(1.0),
                jnp.float32(1.0), jnp.float32(0.0))
  ref = Camera32(bayer.BayerPattern.RGGB, moving_alpha=0.2)
  ref_out = ref.process(raws, gamma=0.8, tonemap="linear")
  assert np.abs(np.asarray(out).astype(int) -
                np.asarray(ref_out).astype(int)).max() <= 1


def _collective_ops(compiled_text):
  import re
  found = {}
  for op in ("all-gather", "all-reduce", "collective-permute",
             "reduce-scatter", "all-to-all"):
    n = len(re.findall(rf"\S+ {op}\(", compiled_text))
    if n:
      found[op] = n
  return found


def test_no_hidden_allgathers_camera_mesh():
  """Per-device work is shard-shaped: the
  compiled camera-mesh step's ONLY collectives are the scalar metering
  all-reduces — no all-gather / no image resharding at any mesh size."""
  raws = _raws(8)
  for n_dev in (2, 8):
    mesh = make_camera_mesh(n_dev)
    isp = Camera32(bayer.BayerPattern.RGGB)
    step = sharded_step_for_isp(isp, mesh, raws.shape)
    prev = replicate(jnp.zeros(9, jnp.float32), mesh)
    args = (shard_cameras(jnp.asarray(raws), mesh), prev,
            jnp.float32(0.9), jnp.float32(1.0), jnp.float32(1.0),
            jnp.float32(1.0), jnp.float32(0.0))
    ops = _collective_ops(jax.jit(step).lower(*args).compile().as_text())
    assert "all-gather" not in ops, ops
    assert "all-to-all" not in ops, ops
    assert ops.get("all-reduce", 0) >= 1, ops


def test_no_hidden_allgathers_spatial_mesh():
  """Row-sharded step: all-reduces (metering + per-image max) plus the
  intended halo collective-permutes — nothing else."""
  from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
  from taichi_image_tpu.parallel import spatial
  h, w = 64, 96
  raws = _raws(2, h=h, w=w)
  mesh = Mesh(np.array(jax.devices()[:4]), (spatial.ROW_AXIS,))
  step = spatial.make_spatial_isp_step(
      mesh, work_dtype=types.f32, pattern=bayer.BayerPattern.RGGB,
      n_cameras=2, image_hw=(h, w))
  raws_s = jax.device_put(jnp.asarray(raws),
                          NamedSharding(mesh, P(None, spatial.ROW_AXIS)))
  prev = jax.device_put(jnp.zeros(9, jnp.float32),
                        NamedSharding(mesh, P()))
  args = (raws_s, prev, jnp.float32(0.9), jnp.float32(1.0),
          jnp.float32(1.0), jnp.float32(1.0), jnp.float32(0.0))
  ops = _collective_ops(step.lower(*args).compile().as_text())
  assert "all-gather" not in ops, ops
  assert ops.get("collective-permute", 0) >= 1, ops
  assert ops.get("all-reduce", 0) >= 1, ops
