"""Independent from-the-paper Malvar2004 demosaic shoot-out.

The Taichi reference validates its MHC demosaic by PSNR against
``colour_demosaicing``'s Malvar2004 (reference test/compare_bayer.py:31-44).
Neither ``taichi`` nor ``colour_demosaicing`` can install in this
environment (no network), so this file carries an independent implementation of the
SAME published filter bank, written directly from the paper:

  H.S. Malvar, L.-W. He, R. Cutler, "High-quality linear interpolation
  for demosaicing of Bayer-patterned color images", ICASSP 2004 —
  the five 5x5 gradient-corrected kernels of Fig. 2.

It uses full-resolution scipy correlation + per-pixel-class masks (the
same formulation colour_demosaicing uses) — NOT the repo's 4-phase conv
decomposition and NOT tests/oracle.py's per-pixel diamond loop. Interior
pixels must agree to float tolerance, pinning the framework's demosaic
to the published coefficients through a third, structurally unrelated
code path.
"""

import numpy as np
import pytest
from scipy.ndimage import correlate

from taichi_image_tpu.ops import bayer as bayer_ops
from taichi_image_tpu.ops.bayer import BayerPattern
from conftest import make_test_rgb, psnr

# Paper Fig. 2, x8. G at R/B locations:
_G_AT_RB = np.array([
    [0, 0, -1, 0, 0],
    [0, 0, 2, 0, 0],
    [-1, 2, 4, 2, -1],
    [0, 0, 2, 0, 0],
    [0, 0, -1, 0, 0],
], np.float64) / 8.0

# R at a G pixel whose horizontal neighbors are R (R row, B column) —
# and by the paper's symmetry, B at a G pixel in a B row / R column.
_RB_AT_G_SAMEROW = np.array([
    [0, 0, 0.5, 0, 0],
    [0, -1, 0, -1, 0],
    [-1, 4, 5, 4, -1],
    [0, -1, 0, -1, 0],
    [0, 0, 0.5, 0, 0],
], np.float64) / 8.0

# vertical same-color neighbors: the transpose
_RB_AT_G_SAMECOL = _RB_AT_G_SAMEROW.T

# R at B locations / B at R locations (diagonal neighbors)
_RB_AT_OPPOSITE = np.array([
    [0, 0, -1.5, 0, 0],
    [0, 2, 0, 2, 0],
    [-1.5, 0, 6, 0, -1.5],
    [0, 2, 0, 2, 0],
    [0, 0, -1.5, 0, 0],
], np.float64) / 8.0


def _masks(pattern_name, shape):
  """Boolean per-channel CFA site masks for a 2x2 pattern string whose
  letters map to sites (0,0),(0,1),(1,0),(1,1)."""
  m = {c: np.zeros(shape, bool) for c in "RGB"}
  for letter, (dy, dx) in zip(pattern_name,
                              ((0, 0), (0, 1), (1, 0), (1, 1))):
    m[letter][dy::2, dx::2] = True
  return m["R"], m["G"], m["B"]


def malvar2004(cfa, pattern_name):
  """Full-resolution Malvar-He-Cutler 2004 demosaic (paper formulation:
  one correlation per kernel, per-pixel-class select). Zero padding —
  only the interior (2-pixel crop) is border-correct."""
  x = cfa.astype(np.float64)
  rm, gm, bm = _masks(pattern_name, x.shape)
  conv = lambda k: correlate(x, k, mode="constant", cval=0.0)
  g = np.where(gm, x, conv(_G_AT_RB))
  horiz = conv(_RB_AT_G_SAMEROW)
  vert = conv(_RB_AT_G_SAMECOL)
  diag = conv(_RB_AT_OPPOSITE)
  r_row = np.any(rm, axis=1, keepdims=True) & np.ones_like(rm)
  b_row = np.any(bm, axis=1, keepdims=True) & np.ones_like(bm)
  r = np.where(rm, x, np.where(gm & r_row, horiz,
                               np.where(gm, vert, diag)))
  b = np.where(bm, x, np.where(gm & b_row, horiz,
                               np.where(gm, vert, diag)))
  return np.stack([r, g, b], -1)


@pytest.fixture(scope="module")
def fixture_img():
  return make_test_rgb(128, 192, seed=3).astype(np.float32)


@pytest.mark.parametrize("pattern", list(BayerPattern))
def test_interior_matches_paper_exactly(fixture_img, pattern):
  """Framework MHC (f32, phase-conv decomposition) == the paper filter
  bank at every interior pixel, to f32 tolerance. This is value-level
  coefficient parity, stronger than the reference's PSNR print."""
  cfa = np.asarray(
      bayer_ops.rgb_to_bayer(fixture_img, pattern)).astype(np.float32)
  ours = np.asarray(bayer_ops.bayer_to_rgb(cfa, pattern)).astype(
      np.float64)
  paper = np.clip(malvar2004(cfa, pattern.name), 0.0, 1.0)
  crop = (slice(2, -2), slice(2, -2))
  np.testing.assert_allclose(ours[crop], paper[crop], atol=2e-6,
                             err_msg=f"{pattern} interior != Malvar2004")


@pytest.mark.parametrize("pattern", list(BayerPattern))
def test_u8_shootout_psnr(fixture_img, pattern):
  """Reference-style shoot-out (compare_bayer.py:31-44) but ASSERTED:
  the u8 pipeline vs the independent paper implementation on the same
  CFA must exceed 50 dB (the cross-implementation floor).
  Interior crop, like the reference comparison (compare_bayer.py:36-38):
  at the 2-pixel border the implementations differ BY DESIGN (this
  file zero-pads; the framework renormalizes dropped taps)."""
  img_u8 = (np.clip(fixture_img, 0, 1) * 255).astype(np.uint8)
  cfa = np.asarray(bayer_ops.rgb_to_bayer(img_u8, pattern))
  ours = np.asarray(bayer_ops.bayer_to_rgb(cfa, pattern)).astype(
      np.float64) / 255.0
  paper = np.clip(malvar2004(cfa.astype(np.float64) / 255.0,
                             pattern.name), 0.0, 1.0)
  crop = (slice(2, -2), slice(2, -2))
  db = psnr(ours[crop], paper[crop])
  assert db > 50.0, f"{pattern}: {db:.2f} dB vs paper Malvar2004"
