"""Multi-camera ISP pipeline tests (reference camera_isp.py semantics)."""

import numpy as np
import pytest

from taichi_image_tpu import types
import taichi_image_tpu.models.camera_isp as isp_mod
from taichi_image_tpu.models.camera_isp import Camera16, Camera32
from taichi_image_tpu.ops import bayer, packed
from taichi_image_tpu.ops.interpolate import ImageTransform
from conftest import make_test_rgb, psnr
from oracle import (isp_linear_oracle, isp_reinhard_oracle,
                    metering_update_oracle, rgb_to_bayer_oracle)


def load_test_image(h=64, w=96, pattern=bayer.BayerPattern.RGGB, seed=0):
  """Synthetic RAW from an RGB photo: mosaic + 12-bit pack (mirrors
  reference test/camera_isp.py:10-21)."""
  img = make_test_rgb(h, w, seed)
  cfa = rgb_to_bayer_oracle(np.clip(img, 0, 1), pattern.name)
  raw = np.asarray(packed.encode12(cfa, scaled=True))
  return raw, img


def test_load_packed12_shapes():
  raw, img = load_test_image()
  isp = Camera32(bayer.BayerPattern.RGGB)
  rgb = np.asarray(isp.load_packed12(raw))
  assert rgb.shape == (64, 96, 3)
  assert rgb.dtype == np.float32
  assert psnr(rgb, img) > 30


def test_load_packed12_f16():
  raw, img = load_test_image()
  isp = Camera16(bayer.BayerPattern.RGGB)
  rgb = np.asarray(isp.load_packed12(raw))
  assert rgb.dtype == np.float16
  assert psnr(rgb.astype(np.float32), img) > 30


def test_load_packed16():
  img = make_test_rgb(32, 48)
  cfa16 = (rgb_to_bayer_oracle(img, "RGGB") * 65535).astype(np.uint16)
  raw = np.asarray(packed.encode16(cfa16))
  isp = Camera32(bayer.BayerPattern.RGGB)
  rgb = np.asarray(isp.load_packed16(raw))
  assert rgb.shape == (32, 48, 3)
  assert psnr(rgb, img) > 30


def test_load_16u():
  img = make_test_rgb(32, 48)
  cfa16 = (rgb_to_bayer_oracle(img, "RGGB") * 65535).astype(np.uint16)
  isp = Camera32(bayer.BayerPattern.RGGB)
  rgb = np.asarray(isp.load_16u(cfa16))
  assert psnr(rgb, img) > 30


def test_load_32f():
  img = make_test_rgb(32, 48)
  cfa = rgb_to_bayer_oracle(img, "RGGB")
  isp = Camera32(bayer.BayerPattern.RGGB)
  rgb = np.asarray(isp.load_32f(cfa))
  assert psnr(rgb, img) > 30


def test_resize_width_policy():
  raw, _ = load_test_image(64, 96)
  isp = Camera32(bayer.BayerPattern.RGGB, resize_width=48)
  rgb = np.asarray(isp.load_packed12(raw))
  assert rgb.shape == (32, 48, 3)


def test_scale_policy():
  raw, _ = load_test_image(64, 96)
  isp = Camera32(bayer.BayerPattern.RGGB, scale=0.5)
  rgb = np.asarray(isp.load_packed12(raw))
  assert rgb.shape == (32, 48, 3)


def test_scale_and_width_mutually_exclusive():
  with pytest.raises(ValueError):
    Camera32(bayer.BayerPattern.RGGB, scale=0.5, resize_width=100)


def test_set_reconfig():
  isp = Camera32(bayer.BayerPattern.RGGB, scale=0.5)
  isp.set(resize_width=48)
  assert isp.resize_width == 48 and isp.scale is None
  isp.set(scale=0.25)
  assert isp.scale == 0.25 and isp.resize_width == 0
  isp.set(moving_alpha=0.5, correct_colors=True,
          transform=ImageTransform.rotate_90)
  assert isp.moving_alpha == 0.5 and isp.correct_colors
  assert isp.transform == ImageTransform.rotate_90


def test_color_correct_matrix_folds_wb():
  isp = Camera32(bayer.BayerPattern.RGGB, correct_colors=True,
                 white_balance=np.array([2.0, 1.0, 3.0]))
  cc = isp.color_correct_matrix
  want = isp_mod.default_cc.copy()
  want[:, 0] *= 2.0
  want[:, 2] *= 3.0
  np.testing.assert_allclose(cc, want)
  isp2 = Camera32(bayer.BayerPattern.RGGB, correct_colors=False)
  assert isp2.color_correct_matrix is None


def test_metering_update_vs_oracle():
  imgs = np.stack([make_test_rgb(40, 40, seed=s) for s in range(3)])
  prev = np.zeros(9, np.float32)
  from taichi_image_tpu.models.camera_isp import metering_update
  got = np.asarray(metering_update(imgs, prev, 0.0))
  want = metering_update_oracle(imgs, prev, 0.0)
  np.testing.assert_allclose(got, want, atol=1e-5)
  # second update with EMA
  prev2 = want
  got2 = np.asarray(metering_update(imgs * 0.5, prev2, 0.9))
  want2 = metering_update_oracle(imgs * 0.5, prev2, 0.9)
  np.testing.assert_allclose(got2, want2, atol=1e-5)


def test_metering_ema_seeding():
  raw, _ = load_test_image()
  isp = Camera32(bayer.BayerPattern.RGGB, moving_alpha=0.1)
  images = [isp.load_packed12(raw) for _ in range(2)]
  isp.update_metering(images)
  first = np.asarray(isp.metrics).copy()
  # second update with identical images: EMA of identical stats is stable
  isp.update_metering(images)
  second = np.asarray(isp.metrics)
  np.testing.assert_allclose(first, second, atol=1e-4)


def test_reinhard_apply_vs_oracle():
  img = make_test_rgb(48, 64)
  metrics = metering_update_oracle(img[None], np.zeros(9, np.float32), 0.0)
  from taichi_image_tpu.models.camera_isp import reinhard_apply
  import jax.numpy as jnp
  got = np.asarray(reinhard_apply(jnp.asarray(img), jnp.asarray(metrics),
                                  0.9, 2.0, 0.8, 0.2, types.f32))
  want = isp_reinhard_oracle(img, metrics, 0.9, 2.0, 0.8, 0.2)
  assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_linear_apply_vs_oracle():
  img = make_test_rgb(48, 64)
  metrics = metering_update_oracle(img[None], np.zeros(9, np.float32), 0.0)
  from taichi_image_tpu.models.camera_isp import linear_apply
  import jax.numpy as jnp
  got = np.asarray(linear_apply(jnp.asarray(img), jnp.asarray(metrics), 0.8))
  want = isp_linear_oracle(img, metrics, 0.8)
  assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_tonemap_reinhard_six_cameras():
  raw, _ = load_test_image()
  isp = Camera32(bayer.BayerPattern.RGGB, moving_alpha=1.0)
  images = [isp.load_packed12(raw) for _ in range(6)]
  outputs = isp.tonemap_reinhard(images, gamma=0.6)
  assert len(outputs) == 6
  out = np.asarray(outputs[0])
  assert out.dtype == np.uint8 and out.shape == (64, 96, 3)
  # all cameras identical input -> identical output
  np.testing.assert_array_equal(out, np.asarray(outputs[5]))
  assert out.max() > 100  # produced a reasonably exposed image


def test_tonemap_linear_cameras():
  raw, _ = load_test_image()
  isp = Camera32(bayer.BayerPattern.RGGB)
  images = [isp.load_packed12(raw) for _ in range(2)]
  outputs = isp.tonemap_linear(images, gamma=1.0)
  assert len(outputs) == 2 and np.asarray(outputs[0]).dtype == np.uint8


def test_transform_applied_to_outputs():
  raw, _ = load_test_image(64, 96)
  isp = Camera32(bayer.BayerPattern.RGGB,
                 transform=ImageTransform.rotate_90)
  images = [isp.load_packed12(raw)]
  outputs = isp.tonemap_reinhard(images)
  assert np.asarray(outputs[0]).shape == (96, 64, 3)


def test_tonemap_only():
  raw, _ = load_test_image()
  isp = Camera32(bayer.BayerPattern.RGGB)
  img = isp.load_packed12(raw)
  isp.update_metering([img])
  out = np.asarray(isp.tonemap_only(img, isp.metrics, 1.0, 1.0, 1.0, 0.0))
  assert out.dtype == np.uint8 and out.shape == (64, 96, 3)


def test_fused_step_matches_composed_path():
  """The one-jit fused step must produce the same outputs and metering
  state as the reference-style composed path (load_* + tonemap_*)."""
  raw, _ = load_test_image(64, 96)
  raws = np.stack([raw] * 3)

  composed = Camera32(bayer.BayerPattern.RGGB, moving_alpha=0.2)
  images = [composed.load_packed12(r) for r in raws]
  out_composed = composed.tonemap_reinhard(images, gamma=0.8, intensity=2.0)

  fused = Camera32(bayer.BayerPattern.RGGB, moving_alpha=0.2)
  out_fused = fused.process(raws, gamma=0.8, intensity=2.0, layout="hwc")

  np.testing.assert_allclose(np.asarray(fused.metrics),
                             np.asarray(composed.metrics), atol=1e-5)
  for i in range(3):
    got = np.asarray(out_fused[i]).astype(int)
    want = np.asarray(out_composed[i]).astype(int)
    assert np.abs(got - want).max() <= 1

  # second frame exercises the EMA path
  out2_c = composed.tonemap_reinhard(images, gamma=0.8, intensity=2.0)
  out2_f = fused.process(raws, gamma=0.8, intensity=2.0, layout="hwc")
  np.testing.assert_allclose(np.asarray(fused.metrics),
                             np.asarray(composed.metrics), atol=1e-5)
  assert np.abs(np.asarray(out2_f[0]).astype(int)
                - np.asarray(out2_c[0]).astype(int)).max() <= 1


def test_fused_step_with_resize_and_transform():
  raw, _ = load_test_image(64, 96)
  raws = np.stack([raw] * 2)
  isp = Camera32(bayer.BayerPattern.RGGB, resize_width=48,
                 transform=ImageTransform.rotate_90)
  out = np.asarray(isp.process(raws))
  assert out.shape == (2, 3, 48, 32)  # planar (n, c, h, w)
  out_hwc = isp.process(raws, layout="hwc")
  assert out_hwc.shape == (2, 48, 32, 3)


def test_fused_linear():
  raw, _ = load_test_image(64, 96)
  isp = Camera32(bayer.BayerPattern.RGGB)
  out = np.asarray(isp.process(np.stack([raw]), tonemap="linear"))
  assert out.dtype == np.uint8


def test_camera_bf16():
  raw, img = load_test_image()
  isp = isp_mod.CameraBF16(bayer.BayerPattern.RGGB)
  out = isp.process(np.stack([raw] * 2), gamma=0.8)
  assert np.asarray(out).dtype == np.uint8
  # bf16 working dtype should still produce a clean image
  f32 = Camera32(bayer.BayerPattern.RGGB)
  ref = f32.process(np.stack([raw] * 2), gamma=0.8)
  diff = np.abs(np.asarray(out).astype(int) - np.asarray(ref).astype(int))
  assert diff.mean() < 4.0


def test_moving_average_helper():
  assert isp_mod.moving_average(None, 5.0, 0.1) == 5.0
  assert isp_mod.moving_average(0.0, 10.0, 0.1) == pytest.approx(1.0)


def test_resize_image_method():
  isp = Camera32(bayer.BayerPattern.RGGB, resize_width=48)
  img = make_test_rgb(64, 96)
  out = np.asarray(isp.resize_image(img))
  assert out.shape == (32, 48, 3)
  isp2 = Camera32(bayer.BayerPattern.RGGB)
  np.testing.assert_array_equal(np.asarray(isp2.resize_image(img)), img)


def test_metering_images_functional():
  isp = Camera32(bayer.BayerPattern.RGGB)
  imgs = [make_test_rgb(32, 32, seed=s) for s in range(2)]
  m = np.asarray(isp.metering_images(imgs, 0.0, np.zeros(9, np.float32)))
  assert m.shape == (9,)
  assert isp.metrics is None  # functional: does not mutate the EMA state


def test_state_dict_roundtrip():
  raw, _ = load_test_image()
  isp = Camera32(bayer.BayerPattern.RGGB)
  isp.process(np.stack([raw]))
  state = isp.state_dict()
  isp2 = Camera32(bayer.BayerPattern.RGGB)
  isp2.load_state(state)
  np.testing.assert_array_equal(np.asarray(isp2.metrics),
                                np.asarray(isp.metrics))
  # fresh pipelines report empty state
  assert Camera32(bayer.BayerPattern.RGGB).state_dict()["metrics"] is None


def test_state_dict_carries_white_balance():
  """AWB made white_balance cross-frame algorithmic state: converged
  gains must survive checkpoint/resume (and pre-AWB checkpoints
  without the key still load)."""
  raws = _casted_raws(cast=(0.6, 1.0, 1.4))
  isp = Camera32(bayer.BayerPattern.RGGB, correct_colors=True,
                 color_correction=np.eye(3, dtype=np.float64),
                 moving_alpha=1.0)
  isp.process(raws)
  wb = isp.auto_white_balance()
  state = isp.state_dict()
  isp2 = Camera32(bayer.BayerPattern.RGGB, correct_colors=True,
                  color_correction=np.eye(3, dtype=np.float64))
  isp2.load_state(state)
  np.testing.assert_array_equal(isp2.white_balance, wb)
  # gains quantize to 1/256: a converged loop is a jit-cache fixed point
  assert np.all(wb * 256 == np.round(wb * 256))
  isp2.load_state({"metrics": state["metrics"]})  # pre-AWB checkpoint
  np.testing.assert_array_equal(isp2.white_balance, wb)  # unchanged


def test_tonemap_gamma():
  from taichi_image_tpu.ops.tonemap import tonemap_gamma
  src = make_test_rgb(16, 16)
  out = np.asarray(tonemap_gamma(src, gamma=2.0))
  want = np.clip(np.power(src, 0.5), 0, 1) * 255
  assert np.abs(out.astype(int) - want.astype(np.uint8).astype(int)).max() <= 1


def test_types_alloc_compat():
  from taichi_image_tpu import types as t
  a = np.zeros((4, 5), np.uint16)
  b = t.empty_like(a)
  assert b.shape == (4, 5) and b.dtype == np.uint16
  c = t.zeros_like(a, shape=(2, 2), dtype=np.float32)
  assert c.shape == (2, 2) and c.dtype == np.float32 and c.sum() == 0


def test_process_stream():
  raw, _ = load_test_image(64, 96)
  isp = Camera32(bayer.BayerPattern.RGGB, moving_alpha=0.3)

  def frames():
    for s in range(5):
      yield np.stack([raw, raw])

  outs = list(isp.process_stream(frames(), gamma=0.8))
  assert len(outs) == 5
  # identical to the step-by-step path
  ref = Camera32(bayer.BayerPattern.RGGB, moving_alpha=0.3)
  for i in range(5):
    want = ref.process(np.stack([raw, raw]), gamma=0.8)
    np.testing.assert_array_equal(np.asarray(outs[i]), np.asarray(want))


def test_exposure_adaptation_soak():
  """EMA metering adapts smoothly to an exposure step change."""
  img = make_test_rgb(64, 96)
  bright = rgb_to_bayer_oracle(np.clip(img, 0, 1), "RGGB")
  dark = bright * 0.25
  raw_b = np.stack([np.asarray(packed.encode12(bright, scaled=True))])
  raw_d = np.stack([np.asarray(packed.encode12(dark, scaled=True))])

  isp = Camera32(bayer.BayerPattern.RGGB, moving_alpha=0.2)
  isp.process(raw_b)
  b_max0 = float(np.asarray(isp.metrics)[1])
  maxes = []
  for _ in range(10):
    isp.process(raw_d)
    maxes.append(float(np.asarray(isp.metrics)[1]))
  # EMA bounds decay monotonically toward the dark frame's max
  assert all(maxes[i + 1] <= maxes[i] + 1e-6 for i in range(9))
  # The reference DOUBLE-blends the bounds: once for normalization and
  # once inside the final vec9 lerp (camera_isp.py:156-166), so the
  # effective per-step new-frame weight is alpha^2, retain = 1 - alpha^2:
  #   final = a*(a*new + (1-a)*prev) + (1-a)*prev -> 0.04*new + 0.96*prev
  dark_max = 0.25 * b_max0  # dark frames are the bright frame x 0.25
  expect = dark_max + (b_max0 - dark_max) * (1 - 0.2 ** 2) ** 10
  assert abs(maxes[-1] - expect) < 0.01


def test_metering_images_does_not_consume_prev():
  import jax.numpy as jnp
  isp = Camera32(bayer.BayerPattern.RGGB)
  imgs = [make_test_rgb(32, 32)]
  prev = jnp.zeros(9, jnp.float32)
  isp.metering_images(imgs, 0.5, prev)
  # prev must remain usable (not donated away)
  assert float(prev.sum()) == 0.0
  isp.metering_images(imgs, 0.5, prev)


def test_fused_u16_and_f32_formats():
  img = make_test_rgb(32, 48)
  cfa16 = (rgb_to_bayer_oracle(img, "RGGB") * 65535).astype(np.uint16)
  cfa32 = rgb_to_bayer_oracle(img, "RGGB")

  isp_a = Camera32(bayer.BayerPattern.RGGB)
  out_a = isp_a.process(np.stack([cfa16]), fmt="u16", layout="hwc")
  composed = Camera32(bayer.BayerPattern.RGGB)
  im = composed.load_16u(cfa16)
  want = composed.tonemap_reinhard([im])[0]
  assert np.abs(out_a[0].astype(int) - np.asarray(want).astype(int)).max() <= 1

  isp_b = Camera32(bayer.BayerPattern.RGGB)
  out_b = isp_b.process(np.stack([cfa32]), fmt="f32", layout="hwc")
  composed_b = Camera32(bayer.BayerPattern.RGGB)
  im_b = composed_b.load_32f(cfa32)
  want_b = composed_b.tonemap_reinhard([im_b])[0]
  assert np.abs(out_b[0].astype(int)
                - np.asarray(want_b).astype(int)).max() <= 1


def test_fused_ids_format():
  img = make_test_rgb(32, 48)
  cfa = rgb_to_bayer_oracle(img, "RGGB")
  raw = np.asarray(packed.encode12(cfa, scaled=True, ids_format=True))

  fused = Camera32(bayer.BayerPattern.RGGB)
  out_f = fused.process(np.stack([raw]), ids_format=True, layout="hwc")
  composed = Camera32(bayer.BayerPattern.RGGB)
  im = composed.load_packed12(raw, ids_format=True)
  want = composed.tonemap_reinhard([im])[0]
  assert np.abs(out_f[0].astype(int) - np.asarray(want).astype(int)).max() <= 1


def test_fused_correct_colors():
  raw, _ = load_test_image(32, 48)
  fused = Camera32(bayer.BayerPattern.RGGB, correct_colors=True)
  out_f = fused.process(np.stack([raw]), layout="hwc")
  composed = Camera32(bayer.BayerPattern.RGGB, correct_colors=True)
  im = composed.load_packed12(raw)
  want = composed.tonemap_reinhard([im])[0]
  assert np.abs(out_f[0].astype(int) - np.asarray(want).astype(int)).max() <= 1


def test_fused_yuv420_output():
  """Fused I420 emission equals yuv420(rgb_output) of the composed path."""
  from taichi_image_tpu.ops import color
  raw, _ = load_test_image(64, 96)
  raws = np.stack([raw, raw])

  fused = Camera32(bayer.BayerPattern.RGGB, moving_alpha=0.2)
  y, uv = fused.process(raws, gamma=0.8, color_format="yuv420")
  assert np.asarray(y).shape == (2, 64, 96)
  assert np.asarray(uv).shape == (2, 2, 32, 48)

  ref = Camera32(bayer.BayerPattern.RGGB, moving_alpha=0.2)
  rgb = ref.process(raws, gamma=0.8, layout="hwc")
  for i in range(2):
    want = np.asarray(color.rgb_yuv420_image(rgb[i]))  # (3H/2, W) u8
    want_y = want[:64]
    want_uv = want[64:].reshape(2, 32, 48)
    assert np.abs(np.asarray(y[i]).astype(int)
                  - want_y.astype(int)).max() <= 1
    assert np.abs(np.asarray(uv[i]).astype(int)
                  - want_uv.astype(int)).max() <= 1


def test_fused_yuv420_bf16_mxu_path():
  """The bf16 pipeline's I420 rides the single-dot formulation
  (yuv420_from_phases_u8 dot=True); values must stay within 1 count of
  the f32 two-chain formulation on the same u8 RGB, and within 1 count
  of the yuv420(rgb_output) oracle."""
  import jax
  import jax.numpy as jnp
  from taichi_image_tpu.models.camera_isp import (
      CameraBF16, _yuv420_phases_dot_bf16, yuv420_from_phases_u8)
  from taichi_image_tpu.ops import color
  raw, _ = load_test_image(64, 96)
  raws = np.stack([raw, raw])

  fused = CameraBF16(bayer.BayerPattern.RGGB, moving_alpha=0.2)
  y, uv = fused.process(raws, gamma=0.8, color_format="yuv420")
  ref = CameraBF16(bayer.BayerPattern.RGGB, moving_alpha=0.2)
  rgb = ref.process(raws, gamma=0.8, layout="hwc")
  for i in range(2):
    want = np.asarray(color.rgb_yuv420_image(rgb[i]))
    assert np.abs(np.asarray(y[i]).astype(int)
                  - want[:64].astype(int)).max() <= 1
    assert np.abs(np.asarray(uv[i]).astype(int)
                  - want[64:].reshape(2, 32, 48).astype(int)).max() <= 1

  # dot formulation vs f32 two-chain on the same u8 phases
  rng = np.random.default_rng(7)
  u8_12 = jnp.asarray(rng.integers(0, 256, size=(2, 12, 16, 24),
                                   dtype=np.uint8))
  dy, duv = jax.jit(_yuv420_phases_dot_bf16)(u8_12)
  cy, cuv = jax.jit(lambda x: yuv420_from_phases_u8(x, dot=False))(u8_12)
  assert np.abs(np.asarray(dy).astype(int)
                - np.asarray(cy).astype(int)).max() <= 1
  assert np.abs(np.asarray(duv).astype(int)
                - np.asarray(cuv).astype(int)).max() <= 1


@pytest.mark.parametrize("transform", [ImageTransform.rotate_90,
                                       ImageTransform.flip_vert])
def test_fused_yuv420_composes_with_transform(transform):
  """yuv420 + output transform: equals yuv420(transformed rgb output)."""
  from taichi_image_tpu.ops import color
  raw, _ = load_test_image(64, 96)
  raws = np.stack([raw, raw])

  fused = Camera32(bayer.BayerPattern.RGGB, moving_alpha=0.2,
                   transform=transform)
  y, uv = fused.process(raws, gamma=0.8, color_format="yuv420")

  ref = Camera32(bayer.BayerPattern.RGGB, moving_alpha=0.2,
                 transform=transform)
  rgb = ref.process(raws, gamma=0.8, layout="hwc")
  h, w = rgb[0].shape[:2]
  assert np.asarray(y).shape == (2, h, w)
  for i in range(2):
    want = np.asarray(color.rgb_yuv420_image(rgb[i]))
    assert np.abs(np.asarray(y[i]).astype(int)
                  - want[:h].astype(int)).max() <= 1
    assert np.abs(np.asarray(uv[i]).astype(int)
                  - want[h:].reshape(2, h // 2, w // 2).astype(int)
                  ).max() <= 1


def test_fused_yuv420_composes_with_resize():
  """yuv420 + resize: equals yuv420(resized rgb output)."""
  from taichi_image_tpu.ops import color
  raw, _ = load_test_image(64, 96)
  raws = np.stack([raw, raw])

  fused = Camera32(bayer.BayerPattern.RGGB, moving_alpha=0.2,
                   resize_width=48)
  y, uv = fused.process(raws, gamma=0.8, color_format="yuv420")
  assert np.asarray(y).shape == (2, 32, 48)
  assert np.asarray(uv).shape == (2, 2, 16, 24)

  ref = Camera32(bayer.BayerPattern.RGGB, moving_alpha=0.2,
                 resize_width=48)
  rgb = ref.process(raws, gamma=0.8, layout="hwc")
  for i in range(2):
    want = np.asarray(color.rgb_yuv420_image(rgb[i]))
    assert np.abs(np.asarray(y[i]).astype(int)
                  - want[:32].astype(int)).max() <= 1
    assert np.abs(np.asarray(uv[i]).astype(int)
                  - want[32:].reshape(2, 16, 24).astype(int)).max() <= 1


def test_fused_yuv420_odd_output_raises():
  raw, _ = load_test_image(64, 96)
  raws = np.stack([raw, raw])
  isp = Camera32(bayer.BayerPattern.RGGB, resize_width=50)  # h' = 33, odd
  with pytest.raises(ValueError, match="even"):
    isp.process(raws, color_format="yuv420")


def test_process_unknown_color_format_raises():
  raw, _ = load_test_image(64, 96)
  raws = np.stack([raw, raw])
  isp = Camera32(bayer.BayerPattern.RGGB)
  with pytest.raises(ValueError, match="color_format"):
    isp.process(raws, color_format="hsv")


@pytest.mark.parametrize("t", [t for t in ImageTransform
                               if t != ImageTransform.none])
def test_phase_space_transforms(t, rng):
  """planar_from_phases_transformed == transform(interleave) bitwise for
  all 7 non-identity transforms (the phase-permutation table)."""
  import jax.numpy as jnp
  from taichi_image_tpu.models.camera_isp import (
      _transform_planar, planar_from_phases_transformed)
  from taichi_image_tpu.ops.bayer import phases_to_planar
  x12 = jnp.asarray(rng.integers(0, 256, size=(2, 12, 6, 8),
                                 dtype=np.uint8))
  ref = np.asarray(_transform_planar(phases_to_planar(x12), t))
  got = np.asarray(planar_from_phases_transformed(x12, t))
  assert np.array_equal(ref, got), t


@pytest.mark.parametrize("size,scale", [((24, 14), None), ((48, 32), None),
                                        ((24, 16), 0.5), ((36, 24), 0.75)])
def test_resize_from_phases_bitwise(size, scale, rng):
  """_resize_from_phases == _resize_planar(phases_to_planar(...)) exactly
  (same sources, same f32 lerp arithmetic) — the fused step's resize path."""
  import jax.numpy as jnp
  from taichi_image_tpu import types
  from taichi_image_tpu.models.camera_isp import (_resize_from_phases,
                                                  _resize_planar)
  from taichi_image_tpu.ops.bayer import phases_to_planar
  x12 = jnp.asarray(rng.random((2, 12, 16, 24)), jnp.bfloat16)
  ref = np.asarray(_resize_planar(phases_to_planar(x12), size, scale,
                                  types.bf16))
  got = np.asarray(_resize_from_phases(x12, size, scale, types.bf16))
  assert np.array_equal(ref.view(np.uint16), got.view(np.uint16))


def test_fused_step_shape_fuzz():
  """Seeded fuzz over shapes/configs: the fused step must produce
  correctly-shaped, finite outputs for arbitrary even geometries and
  config combinations (catches shape-edge bugs like the banded
  mixed-path crash found in round-2 review)."""
  import jax
  import jax.numpy as jnp
  from taichi_image_tpu import types
  from taichi_image_tpu.models.camera_isp import fused_isp_step
  from taichi_image_tpu.ops.bayer import BayerPattern
  from taichi_image_tpu.ops.interpolate import ImageTransform

  rng = np.random.default_rng(42)
  patterns = list(BayerPattern)
  transforms = list(ImageTransform)
  wds = [types.f16, types.f32, types.bf16]
  for trial in range(12):
    n = int(rng.integers(1, 4))
    h = 2 * int(rng.integers(8, 40))
    w = 2 * int(rng.integers(12, 48))
    if (w * 3) % 2:  # packed12 needs W*3/2 integral (w even already)
      continue
    wd = wds[trial % 3]
    pat = patterns[int(rng.integers(0, 4))]
    t = transforms[int(rng.integers(0, len(transforms)))]
    stride = int(rng.choice([2, 4, 8]))
    resize = None
    if rng.random() < 0.3:
      rw = 2 * int(rng.integers(6, max(7, w // 4)))
      rh = 2 * int(rng.integers(6, max(7, h // 4)))
      resize = ((rw, rh), None)
    tonemap = "linear" if rng.random() < 0.3 else "reinhard"
    ids = bool(rng.random() < 0.3)
    # round-3: yuv420 composes with transforms in phase space, so the
    # fuzz no longer excludes the combination (resize+yuv420 needs even
    # output dims, which the fuzz resize does not guarantee)
    cfmt = "yuv420" if (rng.random() < 0.25 and resize is None) else "rgb"
    raws = jnp.asarray(rng.integers(0, 256, size=(n, h, w * 3 // 2),
                                    dtype=np.uint8))
    m, out = jax.jit(lambda r, wd=wd, pat=pat, t=t, s=stride, rz=resize,
                     tm=tonemap, ids=ids, cf=cfmt: fused_isp_step(
        r, jnp.zeros(9, jnp.float32), jnp.float32(0.5), 1.0, 1.0, 1.0,
        0.0, "packed12", ids, wd, pat, None, rz, s, t, tm,
        color_format=cf))(raws)
    if cfmt == "yuv420":
      yh, yw = ((w, h) if t in (ImageTransform.rotate_90,
                                ImageTransform.rotate_270,
                                ImageTransform.transpose,
                                ImageTransform.transverse) else (h, w))
      y, uv = out
      assert y.shape == (n, yh, yw), (trial, y.shape)
      assert uv.shape == (n, 2, yh // 2, yw // 2)
      assert np.isfinite(np.asarray(m)).all(), trial
      continue
    if resize is not None:
      eh, ew = resize[0][1], resize[0][0]
    else:
      eh, ew = h, w
    if t in (ImageTransform.rotate_90, ImageTransform.rotate_270,
             ImageTransform.transpose, ImageTransform.transverse):
      eh, ew = ew, eh
    assert out.shape == (n, 3, eh, ew), (trial, out.shape, (n, 3, eh, ew))
    assert out.dtype == jnp.uint8
    assert np.isfinite(np.asarray(m)).all(), trial
    assert np.asarray(out).std() > 0, trial


# ---------------------------------------------------------------------------
# Gray-world auto white balance (framework extension — no reference
# counterpart; rides the EMA metering rgb means, vec9 indices 6:9).
# ---------------------------------------------------------------------------


def _casted_raws(cast, h=64, w=96, n=2, seed=5):
  """RAW batch of a scene with a known per-channel color cast."""
  img = make_test_rgb(h, w, seed)
  img = np.clip(img * np.asarray(cast)[None, None, :], 0,
                1).astype(np.float32)
  cfa = rgb_to_bayer_oracle(img, "RGGB")
  raw = np.asarray(packed.encode12(cfa, scaled=True))
  return np.stack([raw] * n)


def test_auto_white_balance_converges():
  """A blue-heavy cast drives the AWB loop: after a few process+awb
  iterations the post-WB channel means equalize (relative spread well
  under the starting cast) and the gains move the right way."""
  raws = _casted_raws(cast=(0.5, 1.0, 1.6))
  isp = Camera32(bayer.BayerPattern.RGGB, white_balance=[1.0, 1.0, 1.0],
                 correct_colors=True,  # WB applies via the CCM fold
                 color_correction=np.eye(3, dtype=np.float64),
                 moving_alpha=1.0)  # no EMA damping: converge fast
  spreads = []
  for _ in range(6):
    isp.process(raws)
    means = np.asarray(isp.metrics)[6:9]
    spreads.append(float(means.max() / means.min()))
    isp.auto_white_balance()
  wb = isp.white_balance
  assert wb[1] == 1.0  # G==1 convention held
  assert wb[0] > 1.5 and wb[2] < 0.8, wb  # boosts R, cuts B
  assert spreads[-1] < 1.05 < spreads[0], spreads  # means equalized


def test_auto_white_balance_guards():
  isp = Camera32(bayer.BayerPattern.RGGB)
  with pytest.raises(ValueError, match="metering state"):
    isp.auto_white_balance()
  raws = _casted_raws(cast=(1.0, 1.0, 1.0))
  isp.process(raws)
  wb = isp.auto_white_balance(max_gain=2.0)
  assert (wb <= 2.0).all() and (wb >= 0.5).all()
