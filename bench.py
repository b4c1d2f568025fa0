"""Headline benchmark: 6-camera 4K RGGB full ISP throughput on one GPU.

Pipeline per frame set (mirrors reference bench/camera_isp.py:31-35):
packed12 decode -> MHC demosaic -> EMA metering -> Reinhard tonemap -> u8,
6 cameras x 4K (3840x2160), bf16 working dtype, fused planar pipeline,
device-resident input.

Timing: K steps chained (metrics feed forward) inside ONE jit, each with
a DISTINCT byte XORed into its input and every output summed into a
checksum, so XLA can neither CSE the decode+demosaic across iterations
nor drop a tonemap; the host clock spans the call up to
``block_until_ready``.

Prints the card's name and power limit, then ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "device": {...}, ...}

Exits non-zero, printing no result, when JAX finds no GPU.
"""

import json
import subprocess
import time

import numpy as np

N_CAMERAS = 6
H, W = 2160, 3840
K = 10        # chained steps per jit call
REPS = 5      # timed calls (headline = MEDIAN; best reported as extra)


def main():
  from taichi_image_tpu.utils.device import (enable_compile_cache,
                                             require_gpu)
  devs = require_gpu()
  enable_compile_cache()
  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True,
      check=True, timeout=60).stdout.strip().splitlines()[0]
  print(card, flush=True)

  import jax
  import jax.numpy as jnp
  from taichi_image_tpu import types
  from taichi_image_tpu.models.camera_isp import fused_isp_step
  from taichi_image_tpu.ops.bayer import BayerPattern
  from taichi_image_tpu.ops.interpolate import ImageTransform

  rng = np.random.default_rng(0)
  raws = jax.device_put(rng.integers(0, 256,
                                     size=(N_CAMERAS, H, W * 3 // 2),
                                     dtype=np.uint8))

  @jax.jit
  def steps(m, raws):
    acc = jnp.int32(0)
    for i in range(K):
      # distinct input per iteration (no CSE); every output consumed (no DCE)
      m, out = fused_isp_step(
          raws ^ jnp.uint8(i), m, jnp.float32(0.9), 1.0,
          1.0, 1.0, 0.0,
          "packed12", False, types.bf16, BayerPattern.RGGB, None, None, 8,
          ImageTransform.none, "reinhard")
      acc = acc + jnp.sum(out, dtype=jnp.int32)
    return m, acc

  m0 = jnp.zeros(9, jnp.float32)
  jax.block_until_ready(steps(m0, raws))  # compile + warm

  times = []
  for _ in range(REPS):
    t0 = time.perf_counter()
    jax.block_until_ready(steps(m0, raws))
    times.append(time.perf_counter() - t0)
  median = sorted(times)[len(times) // 2]
  best = min(times)
  fps = K * N_CAMERAS / median

  # Logical traffic of one step (each stage's input read and output
  # written once; taichi_image_tpu/utils/stages.py has the per-stage
  # model), as a rate against the same step time.
  from taichi_image_tpu.utils.stages import stage_bytes
  step_bytes = sum(stage_bytes(N_CAMERAS, H, W, 2).values())
  hbm_gbps = step_bytes / (median / K) / 1e9

  # A large bf16 read + write measured in the same process: the rate a
  # plain elementwise pass reaches on this card.
  xs = jnp.ones((N_CAMERAS, 12, H // 2, W // 2), jnp.bfloat16)
  bump = jax.jit(lambda v: v + jnp.bfloat16(1))
  ys = jax.block_until_ready(bump(xs))
  t0 = time.perf_counter()
  for _ in range(20):
    ys = bump(ys)
  jax.block_until_ready(ys)
  copy_gbps = 2 * xs.nbytes * 20 / (time.perf_counter() - t0) / 1e9

  print(json.dumps({
      "metric": "4K RGGB frames/sec, full ISP (unpack->demosaic->tonemap, "
                "bf16), device-resident input",
      "value": round(fps, 2),
      "unit": "frames/s",
      "best": round(K * N_CAMERAS / best, 2),
      "reps": REPS,
      "hbm_gbps": round(hbm_gbps, 1),
      "copy_gbps": round(copy_gbps, 1),
      "pct_copy": round(100 * hbm_gbps / copy_gbps, 1),
      "card": card,
      "device": {"platform": devs[0].platform, "kind": devs[0].device_kind,
                 "count": len(devs)},
  }))


if __name__ == "__main__":
  main()
