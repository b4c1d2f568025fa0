"""Production batch CLI: multi-camera scan folders -> prefetch -> fused
ISP -> JPEG grid.

Reference: ``taichi_image/scripts/tonemap_scan.py`` (the console tool the
reference declares at pyproject.toml:34-35). Differences: raw frame sets
are stacked into one camera batch and run through the ONE fused jitted ISP
step per frame set (instead of per-camera kernel launch loops), and images
are written with PIL instead of OpenCV. ``--show`` is unavailable headless
and replaced by ``--write``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from taichi_image_tpu.models import camera_isp
from taichi_image_tpu.ops.bayer import BayerPattern
from taichi_image_tpu.ops.interpolate import ImageTransform
from taichi_image_tpu.scripts.util import (
    concat_image_grid, find_folder_images, find_scan_folders,
    load_images_iter, load_raw_bytes, progress, write_image)

from taichi_image_tpu.utils.device import enable_compile_cache

def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("--scan", type=Path)
  parser.add_argument("--images", type=Path)
  parser.add_argument("--reverse", action="store_true")
  parser.add_argument("--width", type=int, default=4096)

  # tonemap parameters (reference defaults, tonemap_scan.py:115-121)
  parser.add_argument("--gamma", type=float, default=0.9)
  parser.add_argument("--intensity", type=float, default=3.0)
  parser.add_argument("--color_adapt", type=float, default=0.0)
  parser.add_argument("--light_adapt", type=float, default=0.9)
  parser.add_argument("--moving_alpha", type=float, default=0.02)
  parser.add_argument("--resize_width", type=int, default=0)
  parser.add_argument("--transform", type=ImageTransform,
                      default=ImageTransform.rotate_90)
  parser.add_argument("--correct_colors", action="store_true")
  parser.add_argument("--write", type=Path, default=None)
  parser.add_argument("--rows", type=int, default=2)
  parser.add_argument("--ids_format", action="store_true")
  parser.add_argument("--debug", action="store_true",
                      help="enable checkify validation in the fused step "
                           "(reference: ti.init(debug=True))")
  parser.add_argument("--dtype", choices=["f16", "f32", "bf16"],
                      default="f32")
  parser.add_argument("--pipeline_depth", type=int, default=2,
                      help="device outputs kept in flight before the "
                           "oldest is fetched (0 = fully serial — the "
                           "round-3 driver, kept for same-session "
                           "comparisons)")
  parser.add_argument("--fetch", choices=["rgb", "yuv420"], default="rgb",
                      help="yuv420 fetches fused I420 from the device "
                           "(half the D2H bytes — the win when the "
                           "host link is the bottleneck) and JPEG-encodes "
                           "from YCbCr")
  args = parser.parse_args(argv)
  enable_compile_cache()

  if args.debug:
    import os
    os.environ["TAICHI_IMAGE_TPU_DEBUG"] = "1"

  cls = {"f16": camera_isp.Camera16, "f32": camera_isp.Camera32,
         "bf16": camera_isp.CameraBF16}[args.dtype]
  isp = cls(BayerPattern.RGGB,
            transform=args.transform,
            moving_alpha=args.moving_alpha,
            resize_width=args.resize_width,
            correct_colors=args.correct_colors)

  if args.scan is not None:
    folders, names = find_scan_folders(args.scan)
  elif args.images is not None:
    folders, names = find_folder_images(args.images)
  else:
    raise ValueError("No --scan or --images specified")

  if args.reverse:
    names = list(reversed(names))

  images = load_images_iter(load_raw_bytes, folders, names)
  row_bytes = (args.width * 3) // 2

  from collections import deque
  from concurrent.futures import ThreadPoolExecutor

  from taichi_image_tpu.utils.debug import validate_raw_file

  if args.write is not None:
    args.write.mkdir(exist_ok=True, parents=True)

  def encode_and_write(name, planar):
    # worker thread: planar (n, 3, h, w) host array -> HWC grid -> JPEG
    grid = concat_image_grid(list(np.moveaxis(planar, 1, -1)),
                             rows=args.rows)
    write_image(args.write / f"{Path(name).stem}.jpg", grid)

  def encode_and_write_i420(name, y, uv):
    # worker thread: I420 (Y (n, H, W), UV (n, 2, H/2, W/2)) ->
    # per-camera HWC YCbCr (chroma nearest-upsampled) -> grid -> JPEG.
    # JPEG is natively YCbCr 4:2:0, so PIL encodes this mode without an
    # RGB trip. Plane mapping measured against the RGB output on
    # saturated patches: uv[1] carries the Cr-like plane (red -> 240),
    # uv[0] the Cb-like one. Saturated colors keep the reference
    # yuv_420 kernel's channel-REVERSED matrix quirk
    # (ops/color.py:35-41) — this mode reproduces the reference's
    # yuv420 values, not libjpeg's BT.601.
    cams = []
    for i in range(y.shape[0]):
      cb = uv[i, 0].repeat(2, axis=0).repeat(2, axis=1)
      cr = uv[i, 1].repeat(2, axis=0).repeat(2, axis=1)
      cams.append(np.stack([y[i], cb, cr], axis=-1))
    grid = concat_image_grid(cams, rows=args.rows)
    write_image(args.write / f"{Path(name).stem}.jpg", grid,
                mode="YCbCr")

  def drain(pending, encodes, pool):
    """Fetch the oldest in-flight device output (its D2H copy was
    started at dispatch time) and hand it to an encode worker."""
    name0, out0 = pending.popleft()
    if args.fetch == "yuv420":
      host = tuple(np.asarray(o) for o in out0)
      if args.write is not None:
        encodes.append(pool.submit(encode_and_write_i420, name0, *host))
    else:
      host = np.asarray(out0)
      if args.write is not None:
        encodes.append(pool.submit(encode_and_write, name0, host))
    while len(encodes) > 8:  # bound encode backlog / surface errors
      encodes.pop(0).result()

  # Pipelined driver (reference prefetch philosophy, tonemap_scan.py:70-87,
  # extended to the device boundary): disk reads prefetch one set ahead
  # (load_images_iter); JAX async dispatch overlaps the H2D upload and
  # compute of set k+1 with set k still in flight; copy_to_host_async
  # starts each result's D2H as soon as the step finishes; JPEG encoding
  # runs on a thread pool. The EMA metering chain stays on device, so
  # nothing in the loop blocks until a result is actually consumed.
  pending, encodes = deque(), []
  with ThreadPoolExecutor(max_workers=4) as pool:
    for name, group in progress(images, total=len(names), desc="tonemap"):
      for b in group.values():
        # clear error on a wrong --width instead of scrambled frames
        validate_raw_file(b.size, args.width, "packed12")
      raws = np.stack([b.reshape(-1, row_bytes) for b in group.values()])
      out = isp.process(raws, ids_format=args.ids_format,
                        gamma=args.gamma, intensity=args.intensity,
                        light_adapt=args.light_adapt,
                        color_adapt=args.color_adapt, layout="planar",
                        color_format=("yuv420" if args.fetch == "yuv420"
                                      else "rgb"))
      for o in (out if isinstance(out, tuple) else (out,)):
        try:
          o.copy_to_host_async()
        except AttributeError:
          pass  # non-jax array (numpy fallback paths)
      pending.append((name, out))
      if len(pending) > args.pipeline_depth:
        drain(pending, encodes, pool)
    while pending:
      drain(pending, encodes, pool)
    for f in encodes:
      f.result()


if __name__ == "__main__":
  main()
