"""Resize + rotate benchmark (reference bench/interpolate.py: resize x0.8
+ rot90, f16)."""

from __future__ import annotations

import argparse

import jax
import numpy as np

from taichi_image_tpu.ops import interpolate
from taichi_image_tpu.utils.device import enable_compile_cache, require_gpu
from taichi_image_tpu.utils.benchmark import benchmark


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument("--size", type=int, nargs=2, default=(2160, 3840))
  parser.add_argument("--iterations", type=int, default=10000)
  parser.add_argument("--warmup", type=int, default=100)
  args = parser.parse_args(argv)
  require_gpu()
  enable_compile_cache()

  h, w = args.size
  rng = np.random.default_rng(0)
  img = jax.device_put(
      rng.uniform(0, 1, (h, w, 3)).astype(np.float16))

  @jax.jit
  def resize_rot(x):
    y = interpolate._resize_bilinear(
        x, (int(w * 0.8), int(h * 0.8)), (0.8, 0.8),
        np.dtype(np.float16), np.dtype(np.float16))
    return interpolate.transform(y, interpolate.ImageTransform.rotate_90)

  its = benchmark("resize(x0.8)+rot90", lambda: resize_rot(img),
                  iterations=args.iterations, warmup=args.warmup)
  print(f"resize+rot90: {its:.1f} it/s")


if __name__ == "__main__":
  main()
