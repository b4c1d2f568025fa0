"""Independent third-implementation cross-checks for the quirk contracts.

The non-demosaic quirk
contracts (negated log-max, yuv420 V/U plane order + clamp-arg-order,
the rgb.bgr channel swizzle) were pinned only by hand-written oracles
derived from reading the reference's code. These tests add genuinely
independent implementations the same way test_malvar2004.py did for
demosaic:

* OpenCV's ``cv2.createTonemapReinhard`` (C++): the algorithm the
  reference's ``tonemap_reinhard`` is derived from (identical pipeline:
  min-max normalize -> Rec601 log-luminance stats -> adaptation blend ->
  x/(adapt+x) -> renormalize + gamma). The reference differs from it by
  exactly ONE deliberate delta — ``Bounds(log_min, -log_max)``
  (reference tonemap.py:102). We assert (a) the un-quirked formula
  matches cv2 to <= 2 u8 counts, (b) the framework matches the quirked
  formula, and (c) the quirk is a REAL, visible delta — so a silent
  drift in the quirk replication fails loudly.

* PIL's ``Image.convert("YCbCr")`` (C): independent full-range BT.601.
  The reference's rgb path feeds the RGB matrix a ``rgb.bgr`` swizzle
  (reference color/yuv_420.py:26), so the matching PIL input is the
  channel-REVERSED image; the UV planes land V-then-U
  (yuv_420.py:62-64). Both quirks are asserted as visible deltas, not
  just encoded in the oracle.

* The clamp-arg-order quirk ``tm.clamp(0, 1, x)`` == min(1, x)
  (yuv_420.py:59,62,90): asserted behaviorally — a negative f32 input
  passes through UN-clamped below zero, which a true clamp would kill.
"""

import numpy as np
import pytest

from taichi_image_tpu.ops import color, tonemap

from oracle import rgb_yuv420_oracle, tonemap_reinhard_oracle

cv2 = pytest.importorskip("cv2")
PIL_Image = pytest.importorskip("PIL.Image")


def _hdr_fixture(seed=7, h=64, w=96):
  """HDR-ish RGB f32 where the quirk is VISIBLE: the max pixel is
  strongly chromatic (log_max << 0, so negating it moves the key), and
  no pixel is all-zero after normalization (avoids the reference's own
  0/0 NaN at temp == adapt == 0, which both implementations share)."""
  rng = np.random.default_rng(seed)
  img = (0.05 + 0.6 * rng.random((h, w, 3))).astype(np.float32)
  img[3, 5] = [4.0, 0.1, 0.1]
  img[10, 20] = [0.01, 0.3, 0.3]
  return img


def _cv2_reinhard_u8(img, g, inten, la, ca):
  """cv2 TonemapReinhard -> u8 with a NaN validity mask: cv2 emits a
  0*inf NaN at a pixel whose normalized channel AND adaptation are both
  ~0 (for ca > 0); those pixels are excluded from comparisons instead
  of relying on undefined NaN->u8 cast behavior."""
  tmr = cv2.createTonemapReinhard(gamma=g, intensity=inten,
                                  light_adapt=la, color_adapt=ca)
  out = tmr.process(img.copy())
  valid = ~np.isnan(out)
  u8 = np.clip(np.nan_to_num(out) * 255.0, 0, 255).astype(np.uint8)
  return u8, valid


# ca=1.0 is excluded: adapt_mean can hit 0 on a 0-channel pixel and the
# reference's own math produces 0/0 NaN there (cv2 does too).
@pytest.mark.parametrize("g,inten,la,ca", [
    (1.0, 1.0, 1.0, 0.0),
    (0.9, 1.5, 0.8, 0.5),
    (1.2, 0.5, 0.6, 0.8),
])
def test_unquirked_reinhard_matches_opencv(g, inten, la, ca):
  """The oracle with negate_log_max=False IS OpenCV's TonemapReinhard:
  independent C++ implementation agrees to <= 2 u8 counts."""
  img = _hdr_fixture()
  cv_u8, valid = _cv2_reinhard_u8(img, g, inten, la, ca)
  noq = tonemap_reinhard_oracle(img, gamma=g, intensity=inten,
                                light_adapt=la, color_adapt=ca,
                                negate_log_max=False)
  diff = np.abs(noq.astype(np.int32) - cv_u8.astype(np.int32))[valid]
  assert valid.mean() > 0.999
  assert diff.max() <= 2, f"un-quirked oracle vs cv2: max {diff.max()}"


@pytest.mark.parametrize("g,inten,la,ca", [
    (1.0, 1.0, 1.0, 0.0),
    (0.9, 1.5, 0.8, 0.5),
])
def test_framework_reinhard_is_quirked_opencv(g, inten, la, ca):
  """Framework == quirked formula (<= 1 count), and the negated-log-max
  delta vs OpenCV is LARGE on this fixture — replication drift (either
  losing the quirk or corrupting the formula) fails this test."""
  img = _hdr_fixture()
  fw = np.asarray(tonemap.tonemap_reinhard(img, gamma=g, intensity=inten,
                                           light_adapt=la, color_adapt=ca))
  q = tonemap_reinhard_oracle(img, gamma=g, intensity=inten,
                              light_adapt=la, color_adapt=ca,
                              negate_log_max=True)
  diff_q = np.abs(fw.astype(np.int32) - q.astype(np.int32))
  assert diff_q.max() <= 1, f"framework vs quirked oracle: {diff_q.max()}"

  cv_u8, valid = _cv2_reinhard_u8(img, g, inten, la, ca)
  diff_cv = np.abs(fw.astype(np.int32) - cv_u8.astype(np.int32))[valid]
  # measured: mean |delta| is ~36-45 counts on this fixture
  assert diff_cv.mean() > 5.0, (
      "the negated-log-max quirk should visibly separate the framework "
      f"from un-quirked OpenCV here, got mean {diff_cv.mean():.2f}")


def _pil_ycbcr(rgb_u8):
  return np.asarray(
      PIL_Image.fromarray(rgb_u8, "RGB").convert("YCbCr")).astype(np.float32)


def _down2(plane, h, w):
  return plane.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))


def test_yuv420_matches_pil_bt601():
  """Framework I420 == PIL's independent full-range BT.601 of the
  channel-REVERSED image (the rgb.bgr swizzle), V-then-U plane order:
  Y within 1 count, 2x2-mean chroma within 2 (avg-then-quantize vs
  quantize-then-avg)."""
  rng = np.random.default_rng(11)
  h, w = 64, 96
  img = rng.integers(0, 256, (h, w, 3), np.uint8)
  yuv = np.asarray(color.rgb_yuv420_image(img))
  assert yuv.shape == (h * 3 // 2, w) and yuv.dtype == np.uint8
  y_fw = yuv[:h].astype(np.float32)
  planes = yuv[h:].reshape(2, h // 2, w // 2).astype(np.float32)

  pil = _pil_ycbcr(img[..., ::-1])
  assert np.abs(y_fw - pil[..., 0]).max() <= 1.0
  assert np.abs(planes[1] - _down2(pil[..., 1], h, w)).max() <= 2.0  # U=Cb
  assert np.abs(planes[0] - _down2(pil[..., 2], h, w)).max() <= 2.0  # V=Cr
  # the V/U order is a real contract: swapped planes are way off
  assert np.abs(planes[0] - _down2(pil[..., 1], h, w)).max() > 20.0

  # oracle agrees with the framework bit-for-bit (sanity on the chain)
  np.testing.assert_array_equal(yuv, rgb_yuv420_oracle(img))


def test_yuv420_channel_swizzle_quirk_is_visible():
  """The reference converts rgb THROUGH a .bgr swizzle
  (yuv_420.py:26) — i.e. its 'RGB' conversion is BT.601 of the reversed
  channels. Assert the framework replicates that (vs straight PIL the
  luma is far off on a colorful image)."""
  rng = np.random.default_rng(13)
  h, w = 32, 64
  img = rng.integers(0, 256, (h, w, 3), np.uint8)
  y_fw = np.asarray(color.rgb_yuv420_image(img))[:h].astype(np.float32)
  straight = _pil_ycbcr(img)[..., 0]
  assert np.abs(y_fw - straight).max() > 20.0


def test_yuv420_clamp_is_upper_only():
  """tm.clamp(0, 1, x) == min(1, x): negative values pass through
  un-clamped (a true [0,1] clamp would zero them). Exercised through
  the f32->f32 conversion with an out-of-range input pixel."""
  h, w = 4, 4
  img = np.full((h, w, 3), 0.5, np.float32)
  img[0, 0] = [-2.0, -2.0, -2.0]  # Y of this pixel is negative
  yuv = np.asarray(color.rgb_yuv420_image(img))
  assert yuv.dtype == np.float32
  assert yuv[:h].min() < -0.5, "negative Y must NOT be clamped to 0"
  # and the upper side IS clamped
  img2 = np.full((h, w, 3), 2.0, np.float32)
  yuv2 = np.asarray(color.rgb_yuv420_image(img2))
  assert yuv2[:h].max() <= 1.0
