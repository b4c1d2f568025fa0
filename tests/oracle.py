"""Slow, obviously-correct numpy mirrors of the reference semantics.

These are independent re-implementations (per-pixel loops / plain numpy) of
the behaviors documented in SURVEY.md §2, used as golden oracles since the
Taichi reference cannot run in this environment. Each function cites the
reference behavior it mirrors.
"""

import numpy as np

SCALE = {
    np.dtype(np.uint8): 255.0,
    np.dtype(np.uint16): 65535.0,
    np.dtype(np.int16): 32767.0,
    np.dtype(np.float16): 1.0,
    np.dtype(np.float32): 1.0,
}


def scale_of(dt):
  return SCALE[np.dtype(dt)]


# ---------------------------------------------------------------- packed12
def encode12_oracle(values, scaled=False, ids_format=False):
  """Reference packed.py:59-89."""
  shape = values.shape
  flat = values.reshape(-1)
  if scaled:
    # ti.round rounds half away from zero (not numpy's half-to-even)
    flat = np.floor(flat.astype(np.float32) *
                    (4095.0 / scale_of(values.dtype)) + 0.5).astype(np.uint16)
  else:
    flat = flat.astype(np.uint16)
  p0, p1 = flat[0::2].astype(np.uint32), flat[1::2].astype(np.uint32)
  if not ids_format:
    b0 = p0 & 0xFF
    b1 = ((p1 & 0xF) << 4) | (p0 >> 8)
    b2 = p1 >> 4
  else:
    b0 = p0 >> 4
    b1 = p1 >> 4
    b2 = ((p0 & 0xF) << 4) | (p1 & 0xF)
  out = np.stack([b0, b1, b2], -1).astype(np.uint8).reshape(-1)
  return out.reshape(shape[:-1] + (shape[-1] * 3 // 2,))


def decode12_oracle(data, dtype=np.uint16, scaled=False, ids_format=False):
  """Reference packed.py:91-131."""
  shape = data.shape
  b = data.reshape(-1, 3).astype(np.uint32)
  if not ids_format:
    p0 = ((b[:, 1] & 0xF) << 8) | b[:, 0]
    p1 = (b[:, 2] << 4) | (b[:, 1] >> 4)
  else:
    p0 = (b[:, 0] << 4) | (b[:, 2] & 0xF)
    p1 = (b[:, 1] << 4) | (b[:, 2] >> 4)
  out = np.stack([p0, p1], -1).reshape(-1)
  if scaled:
    out = (out.astype(np.float32) * (scale_of(dtype) / 4095.0)).astype(dtype)
  else:
    out = out.astype(dtype)
  return out.reshape(shape[:-1] + (shape[-1] * 2 // 3,))


def decode16_oracle(data, dtype=np.uint16, scaled=False):
  """Reference packed.py:134-172 (little-endian)."""
  shape = data.shape
  b = data.reshape(-1, 2).astype(np.uint32)
  out = (b[:, 1] << 8) | b[:, 0]
  if scaled:
    out = (out.astype(np.float32) * (scale_of(dtype) / 65535.0)).astype(dtype)
  else:
    out = out.astype(dtype)
  return out.reshape(shape[:-1] + (shape[-1] // 2,))


# ---------------------------------------------------------------- demosaic
def _mirror(w):
  return list(w) + list(w)[:-1][::-1]


def _symmetrical(w):
  rows = _mirror([_mirror(r) for r in w])
  return [x for row in rows for x in row]


_DIAMOND = [(i - 2, x) for i, r in enumerate(
    [(0, 1), (-1, 2), (-2, 3), (-1, 2), (0, 1)]) for x in range(*r)]


def _mhc_tables():
  g_rb, r_g1, r_g2, rb_br, ident = [
      _symmetrical(w) for w in [
          [(-2,), (0, 4), (-2, 4, 8)],
          [(-2,), (-2, 8), (1, 0, 10)],
          [(1,), (-2, 0), (-2, 8, 10)],
          [(-3,), (4, 0), (-3, 0, 12)],
          [(0,), (0, 0), (0, 0, 16)],
      ]
  ]
  b_g1, b_g2 = r_g2, r_g1
  return [
      list(zip(ident, g_rb, rb_br)),
      list(zip(r_g1, ident, b_g1)),
      list(zip(r_g2, ident, b_g2)),
      list(zip(rb_br, g_rb, ident)),
  ]


_KERNEL_PATTERNS = {
    "RGGB": (0, 1, 2, 3),
    "GBRG": (1, 0, 3, 2),
    "GRBG": (2, 3, 0, 1),
    "BGGR": (3, 2, 1, 0),
}

_PIXEL_ORDERS = {
    "RGGB": (0, 1, 1, 2),
    "GRBG": (1, 0, 2, 1),
    "GBRG": (1, 2, 0, 1),
    "BGGR": (2, 1, 1, 0),
}


def rgb_to_bayer_oracle(image, pattern="RGGB"):
  """Reference bayer.py:101-112: p1..p4 at (ee),(eo),(oe),(oo)."""
  p1, p2, p3, p4 = _PIXEL_ORDERS[pattern]
  h, w = image.shape[:2]
  out = np.zeros((h, w), image.dtype)
  out[0::2, 0::2] = image[0::2, 0::2, p1]
  out[0::2, 1::2] = image[0::2, 1::2, p2]
  out[1::2, 0::2] = image[1::2, 0::2, p3]
  out[1::2, 1::2] = image[1::2, 1::2, p4]
  return out


def bayer_to_rgb_oracle(bayer, pattern="RGGB", correct_colors=None,
                        out_dtype=None):
  """Per-pixel mirror of reference bayer.py:137-175: 13-tap stencils with
  dropped-tap renormalization, optional CCM, clamp, rescale, cast."""
  h, w = bayer.shape
  in_scale = scale_of(bayer.dtype)
  out_dtype = np.dtype(out_dtype or bayer.dtype)
  out_scale = scale_of(out_dtype)
  tables = _mhc_tables()
  kernels = [list(zip(_DIAMOND, tables[i]))
             for i in _KERNEL_PATTERNS[pattern]]
  src = bayer.astype(np.float32)
  out = np.zeros((h, w, 3), np.float32)
  # kernel k applied at positions (2i+dy, 2j+dx) with (dy,dx) in order
  # (0,0), (1,0), (0,1), (1,1) -- reference bayer.py:162-175.
  parities = [(0, 0), (1, 0), (0, 1), (1, 1)]
  for k, (dy, dx) in enumerate(parities):
    for y in range(dy, h, 2):
      for x in range(dx, w, 2):
        c = np.zeros(3)
        t = np.zeros(3)
        for (oy, ox), wgt in kernels[k]:
          yy, xx = y + oy, x + ox
          if 0 <= yy < h and 0 <= xx < w:
            c += src[yy, xx] * np.array(wgt, np.float64)
            t += np.array(wgt, np.float64)
        c = c / (in_scale * t)
        if correct_colors is not None:
          c = np.asarray(correct_colors, np.float64).reshape(3, 3) @ c
        out[y, x] = np.clip(c, 0.0, 1.0)
  scaled = out * out_scale
  if out_dtype.kind in "ui":
    return np.clip(scaled, 0, out_scale).astype(out_dtype)
  return scaled.astype(out_dtype)


# ---------------------------------------------------------------- tonemap
def rgb_gray(rgb):
  return rgb @ np.array([0.299, 0.587, 0.114])


def tonemap_linear_oracle(src, gamma=1.0, dtype=np.uint8):
  """Reference tonemap.py:26-46."""
  x = src.astype(np.float32)
  lo, hi = x.min(), x.max()
  y = np.power((x - lo) / (hi - lo), 1.0 / gamma)
  out_scale = scale_of(dtype)
  y = np.clip(y, 0, 1) * out_scale
  dt = np.dtype(dtype)
  return y.astype(dt) if dt.kind == "f" else np.clip(
      y, 0, out_scale).astype(dt)


def tonemap_reinhard_oracle(src, gamma=1.0, intensity=1.0, light_adapt=1.0,
                            color_adapt=0.0, dtype=np.uint8,
                            negate_log_max=True):
  """Reference tonemap.py:134-168 including the negated log-max quirk
  (tonemap.py:102). ``negate_log_max=False`` computes the un-quirked
  formula — which is OpenCV's TonemapReinhard (the algorithm the
  reference derives from); test_independent.py pins that equivalence
  against cv2's own C++ implementation."""
  x = src.astype(np.float32)
  lo, hi = x.min(), x.max()
  temp = (x - lo) / (hi - lo)  # linear_func gamma=1 scale=1 (clamped [0,1])
  temp = np.clip(temp, 0, 1)

  gray = rgb_gray(temp.astype(np.float64))
  log_gray = np.log(np.maximum(gray, 1e-4))
  log_min, log_max = log_gray.min(), log_gray.max()
  log_mean = log_gray.mean()
  gray_mean = gray.mean()
  rgb_mean = temp.reshape(-1, 3).mean(0)

  # Quirk: Bounds(log_min, -log_max)
  b_min, b_max = log_min, (-log_max if negate_log_max else log_max)
  key = (b_max - log_mean) / (b_max - b_min)
  map_key = 0.3 + 0.7 * np.power(key, 1.4)

  mean = gray_mean + color_adapt * (rgb_mean - gray_mean)
  adapt_color = (gray[..., None] +
                 color_adapt * (temp - gray[..., None]))
  adapt_mean = mean + light_adapt * (adapt_color - mean)
  adapt = np.power(np.exp(-intensity) * adapt_mean, map_key)
  mapped = temp / (adapt + temp)

  lo2, hi2 = mapped.min(), mapped.max()
  out_scale = scale_of(dtype)
  y = np.power((mapped - lo2) / (hi2 - lo2), 1.0 / gamma)
  y = np.clip(y, 0, 1) * out_scale
  dt = np.dtype(dtype)
  return y.astype(dt) if dt.kind == "f" else np.clip(
      y, 0, out_scale).astype(dt)


# ---------------------------------------------------------------- resize
def resize_bilinear_oracle(src, size, scale):
  """Reference interpolate.py:59-86 with scalar scale (the ISP path):
  p_src = p_dst / scale, truncation split, edge clamp."""
  w_out, h_out = size
  h, w = src.shape[:2]
  out = np.zeros((h_out, w_out, src.shape[2]), np.float32)
  x = src.astype(np.float32)
  for i in range(h_out):
    for j in range(w_out):
      pi, pj = i / scale, j / scale
      i0, j0 = int(pi), int(pj)
      fi, fj = pi - i0, pj - j0
      i1, j1 = min(i0 + 1, h - 1), min(j0 + 1, w - 1)
      i0, j0 = min(i0, h - 1), min(j0, w - 1)
      y1 = x[i0, j0] + fi * (x[i1, j0] - x[i0, j0])
      y2 = x[i0, j1] + fi * (x[i1, j1] - x[i0, j1])
      out[i, j] = y1 + fj * (y2 - y1)
  return out


# ---------------------------------------------------------------- yuv420
_YUV_M = np.array([
    [0.299, 0.587, 0.114],
    [-0.168736, -0.331264, 0.5],
    [0.5, -0.418688, -0.081312],
])


def rgb_yuv420_oracle(src, out_dtype=None):
  """Reference color/yuv_420.py:38-66 incl. clamp(0,1,x)=min(1,x) quirk and
  V-then-U plane order."""
  in_scale = scale_of(src.dtype)
  out_dtype = np.dtype(out_dtype or src.dtype)
  out_scale = scale_of(out_dtype)
  h, w = src.shape[:2]
  rgbn = src.astype(np.float32) / in_scale
  bgr = rgbn[..., ::-1]
  yuv = bgr @ _YUV_M.T + np.array([0, 0.5, 0.5])
  y = np.minimum(1.0, yuv[..., 0])
  uv_full = yuv[..., 1:]
  uv = uv_full.reshape(h // 2, 2, w // 2, 2, 2).mean(axis=(1, 3))
  uv = np.minimum(1.0, uv)
  out = np.zeros(((h * 3) // 2, w), np.float32)
  out[:h] = y
  planes = out[h:].reshape(2, h // 2, w // 2)
  planes[1] = uv[..., 0]
  planes[0] = uv[..., 1]
  scaled = out * out_scale
  if out_dtype.kind in "ui":
    return np.clip(scaled, 0, out_scale).astype(out_dtype)
  return scaled.astype(out_dtype)


def yuv420_rgb_oracle(yuv, out_dtype=None):
  """Reference color/yuv_420.py:68-92."""
  in_scale = scale_of(yuv.dtype)
  out_dtype = np.dtype(out_dtype or yuv.dtype)
  out_scale = scale_of(out_dtype)
  h = yuv.shape[0] * 2 // 3
  w = yuv.shape[1]
  y = yuv[:h].astype(np.float32)
  planes = yuv[h:].reshape(2, h // 2, w // 2).astype(np.float32)
  u = np.repeat(np.repeat(planes[1], 2, 0), 2, 1)
  v = np.repeat(np.repeat(planes[0], 2, 0), 2, 1)
  packed = np.stack([y, u, v], -1) / in_scale
  bgr = (packed - np.array([0, 0.5, 0.5])) @ np.linalg.inv(_YUV_M).T
  rgb = bgr[..., ::-1]
  rgb = np.minimum(1.0, rgb)
  scaled = rgb * out_scale
  if out_dtype.kind in "ui":
    return np.clip(scaled, 0, out_scale).astype(out_dtype)
  return scaled.astype(out_dtype)


# ------------------------------------------------------------------- ISP
def metering_update_oracle(images, prev, t):
  """Reference camera_isp.py:142-166: two-pass reduction over the stacked
  strided frames with double EMA blend. ``images``: (N, h, w, 3) f32."""
  x = images.astype(np.float32)
  bmin, bmax = x.min(), x.max()
  b = np.array([bmin, bmax]) + t * (prev[:2] - np.array([bmin, bmax]))
  scaled = (x - b[0]) / (b[1] - b[0] + 1e-6)
  gray = rgb_gray(scaled.astype(np.float64))
  log_gray = np.log(np.maximum(gray, 1e-4))
  n = x.shape[0] * x.shape[1] * x.shape[2]
  stats = np.array([
      b[0], b[1], log_gray.min(), log_gray.max(),
      log_gray.sum() / n, gray.sum() / n,
      *(scaled.reshape(-1, 3).sum(0) / n)], np.float32)
  return stats + t * (prev - stats)


def isp_reinhard_oracle(image, metrics, gamma=1.0, intensity=1.0,
                        light_adapt=1.0, color_adapt=0.0,
                        work_dtype=np.float32):
  """Reference camera_isp.py:177-218."""
  m = np.asarray(metrics, np.float32)
  key = (m[3] - m[4]) / (m[3] - m[2])
  map_key = 0.3 + 0.7 * np.power(key, 1.4)
  mean = m[5] + color_adapt * (m[6:9] - m[5])
  x = image.astype(np.float32)
  scaled = (x - m[0]) / (m[1] - m[0])
  gray = rgb_gray(scaled)[..., None]
  adapt_color = gray + color_adapt * (scaled - gray)
  adapt_mean = mean + light_adapt * (adapt_color - mean)
  adapt = np.power(np.exp(-intensity) * adapt_mean, map_key)
  p = scaled / (adapt + scaled)
  # dark pixels below the EMA bounds -> NaN; the reference's atomicMax
  # ignores NaN (fmaxf), corrupted pixels land at 0
  p = np.where(np.isnan(p), 0.0, p)
  p_cast = p.astype(work_dtype)
  max_out = max(1e-6, p.max())
  out = np.power(p_cast.astype(np.float32) / max_out, 1.0 / gamma)
  return np.clip(255.0 * out, 0, 255).astype(np.uint8)


def isp_linear_oracle(image, metrics, gamma=1.0):
  """Reference camera_isp.py:220-227 (negative inputs clipped to 0 before
  the power, where the reference would produce NaN)."""
  m = np.asarray(metrics, np.float32)
  x = image.astype(np.float32)
  y = np.power(np.clip((x - m[0]) / (m[1] - m[0]), 0, None), 1.0 / gamma)
  return np.clip(np.clip(y, 0, 1) * 255.0, 0, 255).astype(np.uint8)


def isp_chain_oracle(raws, prev, t, work_dtype=np.float32, gamma=1.0,
                     intensity=1.0, light_adapt=1.0, color_adapt=0.0,
                     pattern="RGGB", stride=8):
  """The whole per-frame ISP on packed12 frames, composed from the
  oracles above: decode12 -> demosaic -> strided EMA metering over all
  cameras -> Reinhard -> u8 (reference camera_isp.py:333-403).
  ``raws`` is (N, H, W*3/2) u8; returns (metrics, (N, 3, H, W) u8).

  A 16-bit ``work_dtype`` rounds where the pipeline stores that dtype:
  the decoded CFA, the demosaiced RGB, and the mapped ``p`` (inside
  :func:`isp_reinhard_oracle`)."""
  wd = np.dtype(work_dtype)
  rgbs = []
  for raw in raws:
    cfa = decode12_oracle(raw).astype(np.float32) * np.float32(1 / 4095.0)
    cfa = cfa.astype(wd).astype(np.float32)
    rgb = bayer_to_rgb_oracle(cfa, pattern, out_dtype=np.float32)
    rgbs.append(rgb.astype(wd).astype(np.float32))
  rgbs = np.stack(rgbs)
  metrics = metering_update_oracle(rgbs[:, ::stride, ::stride],
                                   np.asarray(prev, np.float32), t)
  with np.errstate(invalid="ignore"):  # dark pixels map to NaN, then 0
    outs = [isp_reinhard_oracle(rgb, metrics, gamma, intensity,
                                light_adapt, color_adapt, work_dtype=wd)
            for rgb in rgbs]
  return metrics, np.stack(outs).transpose(0, 3, 1, 2)
