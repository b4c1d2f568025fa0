"""The single XLA route of every stage against the numpy oracles of
tests/oracle.py: packed12 decode, demosaic (both methods, all patterns,
CCM, odd shapes, the metering sample grid), the Reinhard map and gamma,
the resize plans, and the whole step of each ISP class."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oracle import (bayer_to_rgb_oracle, decode12_oracle, encode12_oracle,
                    isp_chain_oracle, isp_reinhard_oracle,
                    metering_update_oracle, resize_bilinear_oracle)
from taichi_image_tpu import types
from taichi_image_tpu.models import camera_isp as ci
from taichi_image_tpu.ops import bayer
from taichi_image_tpu.ops.bayer import BayerPattern

CCM = tuple(np.array([[1.2, -0.1, -0.1], [-0.05, 1.1, -0.05],
                      [0.0, -0.2, 1.2]], np.float32).ravel())
WORK = {"f32": types.f32, "f16": types.f16, "bf16": types.bf16}


def _cfa(rng, h, w):
  return rng.random((h, w)).astype(np.float32)


def _demosaic(cfa, pattern, cc=None, method="mhc"):
  """Full-res planar (3, H, W) f32 from one CFA through the XLA route."""
  ph = bayer.cfa_phases(jnp.asarray(cfa)[None])
  x12 = bayer.demosaic_phases(ph, pattern, cc=cc, method=method)
  return np.asarray(bayer.phases_to_planar(x12))[0]


def _bilinear_oracle(cfa, pattern):
  """Per-pixel bilinear demosaic: each missing channel is the mean of
  the in-bounds samples of that colour in the 3x3 neighbourhood."""
  h, w = cfa.shape
  order = bayer.pixel_orders[pattern]
  color = np.empty((h, w), np.int64)
  for i in range(h):
    for j in range(w):
      color[i, j] = order[(i % 2) * 2 + (j % 2)]
  out = np.zeros((h, w, 3), np.float64)
  for i in range(h):
    for j in range(w):
      for c in range(3):
        if color[i, j] == c:
          out[i, j, c] = cfa[i, j]
          continue
        vals = [cfa[y, x] for y in range(max(i - 1, 0), min(i + 2, h))
                for x in range(max(j - 1, 0), min(j + 2, w))
                if color[y, x] == c]
        out[i, j, c] = np.mean(vals)
  return np.clip(out, 0, 1).transpose(2, 0, 1)


@pytest.mark.parametrize("cc", [None, "ccm"])
@pytest.mark.parametrize("pattern", list(BayerPattern))
def test_demosaic_matches_oracle(pattern, cc, rng):
  cc = CCM if cc else None
  cfa = _cfa(rng, 16, 24)
  want = bayer_to_rgb_oracle(cfa, pattern.name, correct_colors=cc and
                             np.asarray(cc).reshape(3, 3),
                             out_dtype=np.float32).transpose(2, 0, 1)
  np.testing.assert_allclose(_demosaic(cfa, pattern, cc), want, atol=2e-6)


@pytest.mark.parametrize("shape", [(16, 192), (24, 130), (15, 129)])
@pytest.mark.parametrize("method", ["mhc", "bilinear"])
def test_demosaic_nondivisible_shapes(method, shape, rng):
  """Phase shapes that tile nothing evenly (odd, non-power-of-two)."""
  hh, wh = shape
  cfa = _cfa(rng, 2 * hh, 2 * wh)
  pattern = BayerPattern.GBRG
  got = _demosaic(cfa, pattern, method=method)
  if method == "mhc":
    want = bayer_to_rgb_oracle(cfa, pattern.name,
                               out_dtype=np.float32).transpose(2, 0, 1)
  else:
    want = _bilinear_oracle(cfa, pattern)
  np.testing.assert_allclose(got, want, atol=2e-6)


@pytest.mark.parametrize("pattern", [BayerPattern.RGGB, BayerPattern.BGGR])
def test_demosaic_bilinear_matches_oracle(pattern, rng):
  cfa = _cfa(rng, 12, 20)
  np.testing.assert_allclose(_demosaic(cfa, pattern, method="bilinear"),
                             _bilinear_oracle(cfa, pattern), atol=2e-6)


@pytest.mark.parametrize("out_dtype", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("step", [4, 2])
def test_demosaic_sample_grid(step, out_dtype, rng):
  """The metering sample the demosaic hands out is exactly the strided
  phase-(0, 0) channels of its output."""
  phases = jnp.asarray(rng.random((2, 4, 24, 40), np.float32))
  x12, samp = bayer.demosaic_phases(phases, BayerPattern.RGGB, cc=CCM,
                                    out_dtype=WORK[out_dtype],
                                    sample_step=step)
  assert samp.dtype == x12.dtype == WORK[out_dtype]
  np.testing.assert_array_equal(np.asarray(samp),
                                np.asarray(x12)[:, 0:3, ::step, ::step])


def test_demosaic_tiny_image_renormalizes(rng):
  """A one-phase-row image takes the explicit tap-count division."""
  cfa = _cfa(rng, 2, 8)
  want = bayer_to_rgb_oracle(cfa, "RGGB", out_dtype=np.float32)
  np.testing.assert_allclose(_demosaic(cfa, BayerPattern.RGGB),
                             want.transpose(2, 0, 1), atol=2e-6)


@pytest.mark.parametrize("shape", [(4, 12), (6, 30), (10, 96)])
@pytest.mark.parametrize("ids", [False, True])
@pytest.mark.parametrize("work", ["f32", "f16", "bf16"])
def test_decode_packed12_bit_exact(work, ids, shape, rng):
  """load_raw_phases == decode12_oracle, scaled and cast like the
  pipeline, bit for bit, for both bit layouts and every working dtype."""
  h, w = shape
  codes = rng.integers(0, 4096, size=(2, h, w), dtype=np.uint16)
  raws = np.stack([encode12_oracle(c, ids_format=ids) for c in codes])
  got = np.asarray(ci.load_raw_phases(jnp.asarray(raws), "packed12",
                                      WORK[work], ids))
  dec = np.stack([decode12_oracle(r, ids_format=ids) for r in raws])
  val = (dec.astype(np.float32) * np.float32(1 / 4095.0)).astype(WORK[work])
  want = np.stack([val[:, 0::2, 0::2], val[:, 0::2, 1::2],
                   val[:, 1::2, 0::2], val[:, 1::2, 1::2]], axis=1)
  assert got.dtype == WORK[work]
  np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("ids", [False, True])
@pytest.mark.parametrize("fill", [0, 255, 0xA5])
def test_decode_packed12_extremes(fill, ids):
  raws = np.full((1, 4, 12), fill, np.uint8)
  got = np.asarray(ci.load_raw_phases(jnp.asarray(raws), "packed12",
                                      types.f32, ids))
  dec = decode12_oracle(raws[0], ids_format=ids).astype(np.float32)
  want = dec * np.float32(1 / 4095.0)
  np.testing.assert_array_equal(got[0, 0], want[0::2, 0::2])
  np.testing.assert_array_equal(got[0, 3], want[1::2, 1::2])


@pytest.mark.parametrize("work", ["f32", "f16", "bf16"])
@pytest.mark.parametrize("gamma", [1.0, 0.9, 2.2])
@pytest.mark.parametrize("color_adapt", [0.0, 0.3, 1.0])
def test_reinhard_matches_oracle(color_adapt, gamma, work, rng):
  """Map + per-image max + gamma on planar frames vs the per-image
  oracle (<= 1 u8 count; dark pixels below the EMA bounds included)."""
  wd = WORK[work]
  img = rng.random((2, 12, 16, 3)).astype(np.float32)
  img = img.astype(wd).astype(np.float32)
  metrics = metering_update_oracle(img[:, ::2, ::2] * 0.9 + 0.02,
                                   np.zeros(9, np.float32), 0.0)
  got = np.asarray(ci.reinhard_apply_ca(
      jnp.asarray(img.transpose(0, 3, 1, 2)), jnp.asarray(metrics), gamma,
      1.5, 0.8, color_adapt, wd))
  with np.errstate(invalid="ignore"):
    want = np.stack([isp_reinhard_oracle(im, metrics, gamma, 1.5, 0.8,
                                         color_adapt, work_dtype=wd)
                     for im in img]).transpose(0, 3, 1, 2)
  assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("gamma", [0.9, 0.6, 2.2])
def test_gamma_pow_matches_numpy_pow(gamma, rng):
  """The exp2(log2(x)*c) gamma lowering agrees with numpy's pow to <= 1
  u8 count after quantization, including x == 0 (-inf*c -> exp2 -> 0)."""
  x = np.concatenate([[0.0, 1.0, 1e-6], rng.random(4093)]).astype(
      np.float32)
  want = np.clip(255.0 * np.power(x, 1.0 / gamma), 0, 255).astype(
      np.uint8)
  got_f = np.asarray(ci._gamma_pow(jnp.asarray(x), 1.0 / gamma))
  got = np.clip(255.0 * got_f, 0, 255).astype(np.uint8)
  assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
  assert got_f[0] == 0.0


def test_gamma_pow_negative_and_nan():
  """Negative inputs and NaN give NaN like pow; the caller's clip + u8
  cast then zeroes them the same way on both lowerings."""
  got = np.asarray(ci._gamma_pow(jnp.asarray([-0.5, np.nan], jnp.float32),
                                 1.0 / 0.9))
  assert np.isnan(got).all()


@pytest.mark.parametrize("size,scale", [((24, 16), 0.5), ((12, 8), 0.25),
                                        ((96, 64), 2.0), ((30, 20), 0.625),
                                        ((36, 24), 0.75)])
def test_resize_plans_match_oracle(size, scale, rng):
  """Phase-space bilinear resize == the reference sampling oracle."""
  img = rng.random((32, 48, 3)).astype(np.float32)
  x12 = bayer.planar_to_phases(jnp.asarray(img.transpose(2, 0, 1))[None])
  got = np.asarray(ci._resize_from_phases(x12, size, scale, types.f32))[0]
  want = resize_bilinear_oracle(img, size, scale).transpose(2, 0, 1)
  assert got.shape == want.shape
  np.testing.assert_allclose(got, want, atol=1e-5)


def _packed(rng, n, h, w):
  """Packed12 frames of a bright, smooth scene with noise."""
  yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
  frames = []
  for i in range(n):
    base = 0.5 + 0.3 * np.sin(xx / 7.0 + i) * np.cos(yy / 5.0)
    cfa = np.clip(base + 0.05 * rng.standard_normal((h, w)), 0, 1)
    frames.append(encode12_oracle((cfa * 4095).astype(np.uint16)))
  return np.stack(frames)


@pytest.mark.parametrize("gamma,intensity", [(1.0, 1.0), (0.9, 3.0),
                                             (0.6, 1.0)])
@pytest.mark.parametrize("cls_name", ["Camera16", "Camera32", "CameraBF16"])
def test_full_step_matches_oracle_chain(cls_name, gamma, intensity, rng):
  """ISP.process over two sets (EMA seeded, then blended) == the oracle
  chain decode -> demosaic -> metering -> Reinhard, <= 1 u8 count."""
  cls = getattr(ci, cls_name)
  wd = cls._work_dtype
  raws = _packed(rng, 2, 16, 24)
  isp = cls(BayerPattern.RGGB, moving_alpha=0.25)
  prev, t = np.zeros(9, np.float32), 0.0
  for _ in range(2):
    got = np.asarray(isp.process(raws, gamma=gamma, intensity=intensity))
    m_want, want = isp_chain_oracle(raws, prev, t, work_dtype=wd,
                                    gamma=gamma, intensity=intensity)
    np.testing.assert_allclose(np.asarray(isp.metrics), m_want, rtol=1e-4,
                               atol=1e-5)
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1, d.max()
    prev, t = np.asarray(isp.metrics), 0.75


@pytest.mark.parametrize("color_adapt", [0.3, 1.0])
@pytest.mark.parametrize("cls_name", ["Camera16", "Camera32", "CameraBF16"])
def test_full_step_color_adapt_matches_oracle_chain(cls_name, color_adapt,
                                                    rng):
  cls = getattr(ci, cls_name)
  raws = _packed(rng, 2, 16, 24)
  isp = cls(BayerPattern.RGGB)
  got = np.asarray(isp.process(raws, gamma=0.8, color_adapt=color_adapt))
  _, want = isp_chain_oracle(raws, np.zeros(9, np.float32), 0.0,
                             work_dtype=cls._work_dtype, gamma=0.8,
                             color_adapt=color_adapt)
  assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def _eqns(jaxpr):
  """Every equation of a jaxpr, sub-jaxprs (pjit, scan, ...) included."""
  for e in jaxpr.eqns:
    yield e
    for v in e.params.values():
      for sub in (v if isinstance(v, (tuple, list)) else (v,)):
        inner = getattr(sub, "jaxpr", sub)
        if hasattr(inner, "eqns"):
          yield from _eqns(inner)


def _step_jaxpr(cls, color_format="rgb", resize_plan=None, cc=None):
  raws = jnp.zeros((1, 16, 36), jnp.uint8)
  return jax.make_jaxpr(lambda r, p: ci.fused_isp_step(
      r, p, jnp.float32(0), 0.9, 1.0, 1.0, 0.0, "packed12", False,
      cls._work_dtype, BayerPattern.RGGB, cc, resize_plan, 8,
      ci.ImageTransform.none, "reinhard", color_format=color_format))(
          raws, jnp.zeros(9)).jaxpr


@pytest.mark.parametrize("cls_name", ["Camera16", "Camera32", "CameraBF16"])
def test_each_class_has_one_route(cls_name):
  """The step of every class is decode -> conv demosaic -> XLA map:
  exactly one convolution, no custom call."""
  prims = [e.primitive.name for e in _eqns(_step_jaxpr(getattr(ci,
                                                               cls_name)))]
  assert prims.count("conv_general_dilated") == 1
  assert not any("custom" in p or "pallas" in p for p in prims)


@pytest.mark.parametrize("variant", ["rgb", "ccm", "yuv420", "resize"])
@pytest.mark.parametrize("cls_name", ["Camera16", "Camera32", "CameraBF16"])
def test_f32_contractions_use_highest(cls_name, variant):
  """Every dot or convolution with a float32 operand states HIGHEST
  precision, so the GPU's TF32 tensor-core path can never take it. A
  contraction of bf16 operands (exact integers and dyadic weights)
  accumulates in f32 and is exempt."""
  kw = {"ccm": dict(cc=CCM), "yuv420": dict(color_format="yuv420"),
        "resize": dict(resize_plan=((18, 8), 0.5))}.get(variant, {})
  found = 0
  for e in _eqns(_step_jaxpr(getattr(ci, cls_name), **kw)):
    if e.primitive.name not in ("dot_general", "conv_general_dilated"):
      continue
    if all(v.aval.dtype == jnp.bfloat16 for v in e.invars):
      continue
    found += 1
    prec = e.params["precision"]
    precs = prec if isinstance(prec, tuple) else (prec,)
    assert all(p == jax.lax.Precision.HIGHEST for p in precs), (
        e.primitive.name, prec)
  assert found >= 1
