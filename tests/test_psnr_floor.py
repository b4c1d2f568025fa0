"""Demosaic quality floors, asserted (not just printed).

Reference analogue: test/compare_bayer.py:31-44 prints PSNR of its MHC
demosaic vs colour_demosaicing's bilinear/Malvar2004/Menon2007 and
test/bayer.py prints PSNR vs OpenCV. Neither asserts. Here the same
quantities gate the suite: on a synthetic smooth fixture, MHC must clear
an absolute floor vs the mosaic ground truth and must beat the bilinear
mode by a margin, for all four patterns.
"""

import numpy as np
import pytest

from taichi_image_tpu.ops import bayer as bayer_ops
from taichi_image_tpu.ops.bayer import BayerPattern
from conftest import make_test_rgb, psnr


def _roundtrip(img_u8, pattern, method):
  cfa = np.asarray(bayer_ops.rgb_to_bayer(img_u8, pattern))
  rgb = np.asarray(bayer_ops.bayer_to_rgb(cfa, pattern, method=method))
  return rgb


@pytest.fixture(scope="module")
def fixture_img():
  # smooth, colorful synthetic image; u8 like the reference's photo input
  img = make_test_rgb(128, 192, seed=3)
  return (np.clip(img, 0, 1) * 255).astype(np.uint8)


@pytest.mark.parametrize("pattern", list(BayerPattern))
def test_mhc_absolute_psnr_floor(fixture_img, pattern):
  """MHC demosaic >= 30 dB vs the pre-mosaic image (interior crop: the
  reference comparison also crops borders, compare_bayer.py:36-38)."""
  rgb = _roundtrip(fixture_img, pattern, "mhc")
  crop = (slice(8, -8), slice(8, -8))
  db = psnr(rgb[crop].astype(np.float32) / 255.0,
            fixture_img[crop].astype(np.float32) / 255.0)
  assert db >= 30.0, f"{pattern}: MHC PSNR {db:.2f} dB < 30 dB"


@pytest.mark.parametrize("pattern", list(BayerPattern))
def test_mhc_beats_bilinear(fixture_img, pattern):
  """Malvar-He-Cutler must beat the bilinear mode by a clear margin
  (the reference's rationale for shipping MHC at all)."""
  crop = (slice(8, -8), slice(8, -8))
  ref = fixture_img[crop].astype(np.float32) / 255.0
  mhc = _roundtrip(fixture_img, pattern, "mhc")[crop].astype(
      np.float32) / 255.0
  bil = _roundtrip(fixture_img, pattern, "bilinear")[crop].astype(
      np.float32) / 255.0
  db_mhc, db_bil = psnr(mhc, ref), psnr(bil, ref)
  assert db_mhc >= db_bil + 1.0, (
      f"{pattern}: MHC {db_mhc:.2f} dB not >= bilinear {db_bil:.2f} + 1 dB")


def test_bilinear_has_sane_floor(fixture_img):
  rgb = _roundtrip(fixture_img, BayerPattern.RGGB, "bilinear")
  crop = (slice(8, -8), slice(8, -8))
  db = psnr(rgb[crop].astype(np.float32) / 255.0,
            fixture_img[crop].astype(np.float32) / 255.0)
  assert db >= 25.0


@pytest.mark.parametrize("pattern", list(BayerPattern))
def test_vs_opencv_independent_demosaic(fixture_img, pattern):
  """Cross-implementation check vs OpenCV's debayer (the reference's
  test/bayer.py comparison target): the cv2 pattern mapping must
  reconstruct the image sanely (validates our CFA layout against an
  implementation we didn't write), and our MHC must score at least as
  well as OpenCV's default demosaic."""
  cv2 = pytest.importorskip("cv2")
  from taichi_image_tpu.scripts.compare_bayer import opencv_demosaic

  cfa = np.asarray(bayer_ops.rgb_to_bayer(fixture_img, pattern))
  cv_rgb = opencv_demosaic(cfa, pattern)
  assert cv_rgb is not None

  crop = (slice(8, -8), slice(8, -8))
  ref = fixture_img[crop].astype(np.float32) / 255.0
  db_cv = psnr(cv_rgb[crop].astype(np.float32) / 255.0, ref)
  # a wrong pattern mapping scores ~10-15 dB; a right one scores high
  assert db_cv >= 25.0, f"{pattern}: cv2 mapping broken ({db_cv:.2f} dB)"

  mhc = np.asarray(bayer_ops.bayer_to_rgb(cfa, pattern))[crop]
  db_mhc = psnr(mhc.astype(np.float32) / 255.0, ref)
  assert db_mhc >= db_cv - 0.1, (
      f"{pattern}: MHC {db_mhc:.2f} dB worse than OpenCV {db_cv:.2f} dB")


def test_bf16_full_step_psnr_vs_f32():
  """The bf16 pipeline's full-step output stays > 50 dB PSNR of the f32
  pipeline on the natural fixture. The residual error is metering-stat
  quantization shifting the global Reinhard curve."""
  import jax
  import jax.numpy as jnp
  from conftest import make_test_rgb
  from oracle import rgb_to_bayer_oracle
  from taichi_image_tpu import types
  from taichi_image_tpu.ops import packed
  from taichi_image_tpu.models.camera_isp import fused_isp_step
  from taichi_image_tpu.ops.bayer import BayerPattern
  from taichi_image_tpu.ops.interpolate import ImageTransform

  img = make_test_rgb(128, 192, seed=3)
  cfa = np.clip(rgb_to_bayer_oracle(img, "RGGB"), 0, 1)
  u12 = np.round(cfa * 4095).astype(np.uint16)
  raws = jnp.asarray(np.asarray(packed.encode12(jnp.asarray(u12)))
                     .reshape(1, 128, 192 * 3 // 2))

  outs = {}
  for wd in (types.f32, types.bf16):
    _, o = jax.jit(lambda r, wd=wd: fused_isp_step(
        r, jnp.zeros(9, jnp.float32), jnp.float32(0.9), 1.0, 1.0, 1.0,
        0.0, "packed12", False, wd, BayerPattern.RGGB, None, None, 8,
        ImageTransform.none, "reinhard"))(raws)
    outs[wd] = np.asarray(o).astype(np.float64)
  d = outs[types.bf16] - outs[types.f32]
  mse = (d ** 2).mean()
  p = 10 * np.log10(255.0 ** 2 / mse) if mse > 0 else float("inf")
  assert p > 50.0, p
