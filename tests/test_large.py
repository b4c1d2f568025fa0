"""Banded large-frame driver tests: band outputs must match the unbanded
fused step within 1 u8 count (models/large.py; reference parity:
camera_isp.py takes arbitrary HxW)."""

import numpy as np
import pytest

from taichi_image_tpu.models.camera_isp import (Camera16, Camera32,
                                                CameraBF16)
from taichi_image_tpu.models import large
from taichi_image_tpu.ops.bayer import BayerPattern


def _raws(n=2, h=64, w=96, seed=0):
  rng = np.random.default_rng(seed)
  return rng.integers(0, 256, size=(n, h, w * 3 // 2), dtype=np.uint8)


def _assert_band_equal(got, want):
  """Banded == unbanded up to the last-ulp association of the staged
  metering reduction (a separately-compiled program over concatenated
  band samples): <=1 u8 count on a tiny fraction of pixels. Bitwise
  equality is parameter/shape luck, not a contract."""
  d = np.abs(got.astype(int) - want.astype(int))
  assert d.max() <= 1, d.max()
  assert (d != 0).mean() <= 0.05, (d != 0).mean()


def test_band_plan_alignment():
  # band sizes quantize to lcm(stride//2, 16)
  assert large.band_plan(32, 4) == [(0, 16), (16, 32)]
  assert large.band_plan(2160, 8) == [(r, min(r + 272, 2160))
                                      for r in range(0, 2160, 272)]
  # non-divisible: starts stay multiples of stride//2 = 4
  plan = large.band_plan(36, 4)
  assert plan[0][0] == 0 and plan[-1][1] == 36
  for r0, _ in plan:
    assert r0 % 4 == 0
  # degenerate: more bands than rows
  assert large.band_plan(4, 16) == [(0, 4)]


@pytest.mark.parametrize("camera_cls", [Camera32, Camera16, CameraBF16])
@pytest.mark.parametrize("n_bands", [2, 3, 4])
def test_banded_matches_unbanded(camera_cls, n_bands):
  raws = _raws()
  a = camera_cls(BayerPattern.RGGB, moving_alpha=0.2)
  b = camera_cls(BayerPattern.RGGB, moving_alpha=0.2)
  # two steps so the EMA chain (t=0 then t=1-alpha) is exercised
  for seed in (0, 1):
    raws = _raws(seed=seed)
    want = np.asarray(a.process(raws, gamma=0.8, intensity=0.9))
    got = np.asarray(b.process_large(raws, n_bands=n_bands, gamma=0.8,
                                     intensity=0.9))
    _assert_band_equal(got, want)
    np.testing.assert_allclose(np.asarray(b.metrics), np.asarray(a.metrics),
                               rtol=1e-6, atol=1e-7)


def test_banded_with_ccm_and_pattern():
  raws = _raws()
  kw = dict(correct_colors=True, moving_alpha=0.3)
  a = Camera32(BayerPattern.BGGR, **kw)
  b = Camera32(BayerPattern.BGGR, **kw)
  want = np.asarray(a.process(raws))
  got = np.asarray(b.process_large(raws, n_bands=4))
  _assert_band_equal(got, want)


def test_banded_linear_tonemap():
  raws = _raws()
  a = Camera32(BayerPattern.RGGB)
  b = Camera32(BayerPattern.RGGB)
  want = np.asarray(a.process(raws, tonemap="linear", gamma=0.7))
  got = np.asarray(b.process_large(raws, n_bands=2, tonemap="linear",
                                   gamma=0.7))
  _assert_band_equal(got, want)


def test_banded_yuv420():
  raws = _raws()
  a = Camera32(BayerPattern.RGGB)
  b = Camera32(BayerPattern.RGGB)
  wy, wuv = a.process(raws, color_format="yuv420")
  gy, guv = b.process_large(raws, n_bands=2, color_format="yuv420")
  _assert_band_equal(np.asarray(gy), np.asarray(wy))
  _assert_band_equal(np.asarray(guv), np.asarray(wuv))


@pytest.mark.parametrize("resize_kw", [dict(scale=0.5),
                                       dict(resize_width=60)])
def test_banded_composes_with_resize(resize_kw):
  """Banded + resize: bands partition the OUTPUT rows and
  demosaic+resize exactly the tapped input rows — same semantics as the
  unbanded fused step's resize path."""
  raws = _raws(h=96, w=96)
  a = Camera32(BayerPattern.RGGB, moving_alpha=0.2, **resize_kw)
  b = Camera32(BayerPattern.RGGB, moving_alpha=0.2, **resize_kw)
  for seed in (0, 1):  # exercise the EMA chain on the resized metering
    raws = _raws(h=96, w=96, seed=seed)
    want = np.asarray(a.process(raws, gamma=0.8, intensity=0.9))
    got = np.asarray(b.process_large(raws, n_bands=3, gamma=0.8,
                                     intensity=0.9))
    assert got.shape == want.shape
    _assert_band_equal(got, want)
    np.testing.assert_allclose(np.asarray(b.metrics),
                               np.asarray(a.metrics), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("transform_name", ["rotate_90", "flip_vert",
                                            "transverse"])
def test_banded_composes_with_transform(transform_name):
  from taichi_image_tpu.ops.interpolate import ImageTransform
  t = ImageTransform[transform_name]
  raws = _raws()
  a = Camera32(BayerPattern.RGGB, transform=t)
  b = Camera32(BayerPattern.RGGB, transform=t)
  want = np.asarray(a.process(raws, gamma=0.8))
  got = np.asarray(b.process_large(raws, n_bands=2, gamma=0.8))
  assert got.shape == want.shape
  _assert_band_equal(got, want)


def test_banded_resize_and_transform_and_yuv():
  """The full production composition: 96-rows capture -> downscale ->
  rot90 -> I420, banded vs unbanded."""
  from taichi_image_tpu.ops.interpolate import ImageTransform
  raws = _raws(h=96, w=96)
  kw = dict(scale=0.5, transform=ImageTransform.rotate_90)
  a = Camera32(BayerPattern.RGGB, **kw)
  b = Camera32(BayerPattern.RGGB, **kw)
  wy, wuv = a.process(raws, color_format="yuv420")
  gy, guv = b.process_large(raws, n_bands=2, color_format="yuv420")
  _assert_band_equal(np.asarray(gy), np.asarray(wy))
  _assert_band_equal(np.asarray(guv), np.asarray(wuv))


def test_banded_resize_linear():
  raws = _raws(h=96, w=96)
  a = Camera32(BayerPattern.RGGB, scale=0.5)
  b = Camera32(BayerPattern.RGGB, scale=0.5)
  want = np.asarray(a.process(raws, tonemap="linear", gamma=0.7))
  got = np.asarray(b.process_large(raws, n_bands=2, tonemap="linear",
                                   gamma=0.7))
  _assert_band_equal(got, want)


def test_banded_hwc_layout():
  raws = _raws()
  out = Camera32(BayerPattern.RGGB).process_large(raws, n_bands=2,
                                                  layout="hwc")
  assert out.shape == (2, 64, 96, 3) and out.dtype == np.uint8


def test_banded_short_last_band_bf16(rng):
  """A short last band (72 rows = a 32-row band + a 4-row tail in
  phase rows) yields the same shapes and values as the unbanded step
  in the bf16 pipeline."""
  from taichi_image_tpu.models.camera_isp import CameraBF16
  raws = rng.integers(0, 256, size=(1, 72, 384), dtype=np.uint8)
  assert large.band_plan(36, 2) == [(0, 32), (32, 36)]
  a = CameraBF16(BayerPattern.RGGB)
  b = CameraBF16(BayerPattern.RGGB)
  want = np.asarray(a.process(raws))
  got = np.asarray(b.process_large(raws, n_bands=2, driver="loop"))
  assert got.shape == (1, 3, 72, 256)
  _assert_band_equal(got, want)
  assert np.isfinite(np.asarray(b.metrics)).all()


def test_banded_shape_fuzz():
  """Seeded fuzz over the banded driver: dtype x
  pattern x bands x resize x transform x color_format must produce
  correctly-shaped finite outputs and match the unbanded step."""
  from taichi_image_tpu import types as tit_types
  from taichi_image_tpu.models.camera_isp import camera_isp
  from taichi_image_tpu.ops.interpolate import ImageTransform

  rng = np.random.default_rng(7)
  wds = [tit_types.f32, tit_types.f16, tit_types.bf16]
  patterns = list(BayerPattern)
  swap = (ImageTransform.rotate_90, ImageTransform.rotate_270,
          ImageTransform.transpose, ImageTransform.transverse)
  for trial in range(8):
    n = int(rng.integers(1, 3))
    h = 16 * int(rng.integers(3, 8))
    w = 2 * int(rng.integers(24, 60))
    n_bands = int(rng.integers(2, 5))
    wd = wds[trial % 3]
    pat = patterns[int(rng.integers(0, 4))]
    t = (ImageTransform.none if rng.random() < 0.5 else
         list(ImageTransform)[int(rng.integers(0, 8))])
    resize_kw = {}
    eh, ew = h, w
    if rng.random() < 0.5:
      eh, ew = h // 2, w // 2
      resize_kw = dict(scale=0.5)
    cfmt = ("yuv420" if (rng.random() < 0.3 and eh % 2 == 0 and
                         ew % 2 == 0) else "rgb")
    if t in swap:
      eh, ew = ew, eh
    if cfmt == "yuv420" and (eh % 2 or ew % 2):
      cfmt = "rgb"
    raws = _raws(n, h=h, w=w, seed=trial)
    cls = camera_isp(f"Fuzz{trial}", wd)
    a = cls(pat, transform=t, **resize_kw)
    b = cls(pat, transform=t, **resize_kw)
    want = a.process(raws, gamma=0.8, color_format=cfmt)
    got = b.process_large(raws, n_bands=n_bands, gamma=0.8,
                          color_format=cfmt)
    if cfmt == "yuv420":
      for g, wv in zip(got, want):
        _assert_band_equal(np.asarray(g), np.asarray(wv))
    else:
      g = np.asarray(got)
      assert g.shape == (n, 3, eh, ew), (trial, g.shape, (n, 3, eh, ew))
      _assert_band_equal(g, np.asarray(want))


# ---------------------------------------------------------------------------
# lax.scan driver (equal aligned bands, whole set in two programs).
# Values must be BITWISE-equal to the loop driver (same per-band
# programs, same metering math).
# ---------------------------------------------------------------------------


def test_scan_band_size_properties():
  # 8K: hh=2160 at q=16 -> 240 (9 equal bands), <= loop per-band 272
  assert large.scan_band_size(2160, 8, 16) == 240
  assert 2160 % large.scan_band_size(2160, 8, 16) == 0
  # no multiple-of-q divisor <= the loop band size -> None (loop driver)
  assert large.scan_band_size(1080, 8, 16) is None  # 1080 % 16 != 0
  assert large.scan_band_size(8, 4, 16) is None     # fewer rows than q
  # single band when n_bands >= rows/q
  assert large.scan_band_size(32, 16, 16) == 16


def test_scan_driver_matches_loop_bitwise(monkeypatch):
  """scan == loop BITWISE on u8 outputs (metrics to f32 ulps) across
  rgb / yuv420 / transform / linear configs, including a multi-chunk
  finish (chunk rows forced tiny)."""
  import jax
  from taichi_image_tpu import types
  from taichi_image_tpu.ops.interpolate import ImageTransform

  monkeypatch.setattr(large, "_FINISH_CHUNK_ROWS", 16)
  raws = _raws(2, h=128, w=192, seed=3)
  prev = np.zeros(9, np.float32)
  cc = tuple(np.array([[1.2, -0.1, 0.0], [-0.05, 1.1, -0.05],
                       [0.0, -0.1, 1.3]], np.float32).ravel())
  kw = dict(n_bands=2, work_dtype=types.bf16, pattern=BayerPattern.RGGB,
            cc=cc, gamma=0.9, intensity=1.5)
  for extra in ({}, {"color_format": "yuv420"},
                {"transform": ImageTransform.rotate_90,
                 "tonemap": "linear"},
                {"transform": ImageTransform.flip_vert,
                 "color_format": "yuv420"}):
    m_l, o_l = large.process_banded(raws, prev, 0.0, driver="loop",
                                    **kw, **extra)
    m_s, o_s = large.process_banded(raws, prev, 0.0, driver="scan",
                                    **kw, **extra)
    for a, b in zip(jax.tree_util.tree_leaves(o_l),
                    jax.tree_util.tree_leaves(o_s)):
      np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_allclose(np.asarray(m_l), np.asarray(m_s),
                               rtol=0, atol=1e-6)


def test_scan_driver_misuse_raises():
  from taichi_image_tpu import types
  raws = _raws(2, h=64, w=96)
  prev = np.zeros(9, np.float32)
  with pytest.raises(ValueError, match="driver"):
    large.process_banded(raws, prev, 0.0, n_bands=2,
                         work_dtype=types.bf16,
                         pattern=BayerPattern.RGGB, driver="warp")
  # forced scan with a resize plan: no equal-band scan path exists
  with pytest.raises(ValueError, match="scan driver"):
    large.process_banded(raws, prev, 0.0, n_bands=2,
                         work_dtype=types.bf16,
                         pattern=BayerPattern.RGGB, driver="scan",
                         resize_plan=((48, 32), None))


@pytest.mark.parametrize("hh,n_bands", [(2160, 4), (2160, 8), (1080, 3)])
def test_n_bands_is_what_the_caller_asks(hh, n_bands):
  """The band planners take ``n_bands`` as given: no band-size cap
  raises it (8K at n_bands=4 runs as four 544-row bands)."""
  plan = large.band_plan(hh, n_bands)
  assert len(plan) == n_bands
  assert plan[0][0] == 0 and plan[-1][1] == hh
  per = plan[0][1] - plan[0][0]
  assert per % 16 == 0 and per >= hh / n_bands
  b = large.scan_band_size(hh, n_bands, 16)
  if b is not None:
    assert hh % b == 0 and b <= per


def test_auto_driver_skips_sliver_scan(monkeypatch):
  """Divisor-poor row counts (hh = 16 * prime) admit only tiny equal
  bands; auto must take the loop driver there (a 100+-iteration scan of
  slivers loses), while driver='scan' still forces the scan form."""
  from taichi_image_tpu import types
  calls = []
  orig = large._banded_scan_step

  def spy(*a, **k):
    calls.append(1)
    return orig(*a, **k)

  monkeypatch.setattr(large, "_banded_scan_step", spy)
  raws = _raws(1, h=224, w=96)  # hh = 112 = 16 * 7
  prev = np.zeros(9, np.float32)
  kw = dict(n_bands=2, work_dtype=types.bf16,
            pattern=BayerPattern.RGGB)
  m_l, o_l = large.process_banded(raws, prev, 0.0, driver="auto", **kw)
  assert not calls  # only 16-row equal bands exist -> loop
  m_s, o_s = large.process_banded(raws, prev, 0.0, driver="scan", **kw)
  assert calls  # forced scan still runs
  np.testing.assert_array_equal(np.asarray(o_l), np.asarray(o_s))
