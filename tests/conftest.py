"""Test bootstrap: force the CPU backend with 8 virtual devices so
camera-axis sharding and the metering collective run without a GPU
(SURVEY.md §4 implication 3). Must run before jax is imported."""

import os

# force CPU even where a GPU is present
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
  os.environ["XLA_FLAGS"] = (
      flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
  return np.random.default_rng(0)


def make_test_rgb(h=64, w=96, seed=0):
  """Synthetic natural-ish RGB image in [0,1] f32: a shared luminance
  structure (edges + blobs) with smooth low-frequency chroma. Channels are
  correlated like real photos, which is the statistical assumption behind
  Malvar-He-Cutler's cross-channel correction — a decorrelated test image
  would make MHC look worse than bilinear."""
  r = np.random.default_rng(seed)
  yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
  lum = 0.5 + 0.25 * np.sin(2 * np.pi * (xx / w + yy / h))
  for _ in range(5):
    cy, cx = r.uniform(0, h), r.uniform(0, w)
    rad = r.uniform(2, max(4.01, h / 3))
    blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / rad ** 2)
    lum += 0.2 * float(r.uniform(-1, 1)) * blob
  # slow chroma modulation around the shared luminance
  chroma = np.stack([
      0.1 * np.sin(2 * np.pi * xx / w),
      0.1 * np.cos(2 * np.pi * yy / h),
      0.1 * np.sin(2 * np.pi * (xx + yy) / (w + h)),
  ], axis=-1)
  # sharp luminance edges — where MHC's gradient correction beats bilinear
  for _ in range(6):
    y0, x0 = int(r.uniform(0, h * 0.8)), int(r.uniform(0, w * 0.8))
    hh = int(r.uniform(2, max(4.01, h / 3)))
    ww = int(r.uniform(2, max(4.01, w / 3)))
    lum[y0:y0 + hh, x0:x0 + ww] += float(r.uniform(-0.3, 0.3))
  img = lum[..., None] + chroma
  return np.clip(img, 0.02, 0.98).astype(np.float32)


def psnr(a, b, peak=1.0):
  a = np.asarray(a, np.float64)
  b = np.asarray(b, np.float64)
  mse = np.mean((a - b) ** 2)
  if mse == 0:
    return np.inf
  return 10 * np.log10(peak ** 2 / mse)
