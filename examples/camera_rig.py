"""End-to-end example: a simulated 6-camera 4K rig streaming through the
fused ISP, with RGB-grid JPEG output and an I420 branch for a video
encoder.

Run (frames are 4K on a GPU and shrink to a tenth elsewhere):

    python examples/camera_rig.py --frames 8 --out /tmp/rig_out

Demonstrates the full API surface a taichi_image user needs:
  * synthesizing packed12 RAW from RGB (`rgb_to_bayer` + `encode12`) —
    the reference's own test-fixture recipe (test/camera_isp.py:10-21);
  * the fused per-frame step `isp.process` (decode -> demosaic+WB/CCM ->
    EMA metering -> Reinhard -> u8) and the streaming driver
    `isp.process_stream` with device/host overlap;
  * I420 output for video encoders (`color_format="yuv420"`);
  * checkpointing the only cross-frame state (`state_dict`).
"""

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np

# runnable without installation: the repo root is the example's parent
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def synth_scene(h, w, t, n_cams):
  """A moving smooth scene with per-camera exposure differences
  (deterministic in (h, w, t, n_cams))."""
  yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
  frames = []
  for cam in range(n_cams):
    phase = t * 0.3 + cam * 0.7
    r = 0.5 + 0.4 * np.sin(xx / 97.0 + phase)
    g = 0.5 + 0.4 * np.sin(yy / 71.0 - phase * 1.3)
    b = 0.5 + 0.4 * np.sin((xx + yy) / 133.0 + phase * 0.5)
    img = np.stack([r, g, b], axis=-1) * (0.6 + 0.1 * cam)
    frames.append(np.clip(img, 0.0, 1.0))
  return frames


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__)
  ap.add_argument("--frames", type=int, default=8)
  ap.add_argument("--cameras", type=int, default=6)
  ap.add_argument("--height", type=int, default=None)
  ap.add_argument("--width", type=int, default=None)
  ap.add_argument("--out", type=Path, default=Path("/tmp/rig_out"))
  args = ap.parse_args(argv)

  import jax
  import taichi_image_tpu as tit
  from taichi_image_tpu.ops import packed
  from taichi_image_tpu.scripts.util import concat_image_grid, write_image

  # full 4K frames on a GPU, a tenth of that elsewhere
  platform = jax.default_backend()
  h = args.height or (2160 if platform == "gpu" else 216)
  w = args.width or (3840 if platform == "gpu" else 384)
  print(f"platform: {platform}, {args.cameras} cameras of {w}x{h}")

  # --- camera simulator: RGB scene -> packed12 RAW per camera ----------
  def raw_stream():
    for t in range(args.frames):
      frames = synth_scene(h, w, t, args.cameras)
      raws = []
      for img in frames:
        cfa = np.asarray(tit.rgb_to_bayer(img, tit.BayerPattern.RGGB))
        raws.append(np.asarray(packed.encode12(cfa, scaled=True)))
      yield np.stack(raws)  # (n_cams, h, w*3//2) u8

  # --- the rig ----------------------------------------------------------
  isp = tit.Camera16(tit.BayerPattern.RGGB, moving_alpha=0.1,
                     correct_colors=True)

  args.out.mkdir(parents=True, exist_ok=True)
  t0 = time.perf_counter()
  n_done = 0
  for i, out in enumerate(isp.process_stream(raw_stream(), prefetch=2,
                                             gamma=1.0, layout="hwc")):
    grid = concat_image_grid(list(out), rows=2)
    write_image(args.out / f"frame{i:04d}.jpg", grid)
    n_done += 1
  dt = time.perf_counter() - t0
  print(f"RGB: {n_done} frame sets x {args.cameras} cams "
        f"({args.cameras * n_done / dt:.1f} frames/s incl. host I/O + "
        f"JPEG) -> {args.out}")

  # --- I420 branch (what a video encoder consumes) ----------------------
  isp2 = tit.Camera16(tit.BayerPattern.RGGB, moving_alpha=0.1)
  raws = next(iter(raw_stream()))
  y, uv = isp2.process(raws, color_format="yuv420")
  print(f"I420: Y {np.asarray(y).shape} u8 + UV {np.asarray(uv).shape} "
        f"u8 (V-then-U plane order)")

  # --- gray-world auto white balance -------------------------------------
  # the EMA metering already carries per-channel means; each call nudges
  # the WB gains toward equal means (a real rig's AWB feedback loop)
  wb = isp.auto_white_balance(strength=0.7)
  print(f"AWB gains after this scene (G==1 convention): {wb}")

  # --- checkpoint/resume -------------------------------------------------
  state = isp.state_dict()  # EMA metering vec9 + AWB white balance
  isp3 = tit.Camera16(tit.BayerPattern.RGGB, moving_alpha=0.1,
                      correct_colors=True)
  isp3.load_state(state)
  print(f"EMA metering state carried over: {np.asarray(isp3.metrics)}")
  print(f"white balance carried over: {isp3.white_balance}")


if __name__ == "__main__":
  main()
