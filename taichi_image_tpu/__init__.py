"""taichi_image_tpu — a multi-camera camera-ISP framework.

Built from scratch in JAX/XLA with the capabilities of
uc-vision/taichi_image (reference layer map in SURVEY.md §1): packed
12/16-bit RAW codecs, Malvar-He-Cutler + bilinear demosaic for all four
Bayer patterns, white balance / color correction, resize + the eight image
transforms, linear/Reinhard tonemapping with EMA exposure metering,
YUV420/grayscale conversions, and a multi-camera streaming ISP whose whole
per-frame step is one jitted, donated, shardable function.
"""

from taichi_image_tpu import types
from taichi_image_tpu.ops import bayer, color, interpolate, kernel, packed, tonemap
from taichi_image_tpu.models.camera_isp import (
    Camera16, Camera32, CameraBF16, camera_isp, default_cc, moving_average)
from taichi_image_tpu.ops.bayer import (
    BayerPattern, bayer_to_rgb, bayer_to_rgb_batch, rgb_to_bayer)
from taichi_image_tpu.ops.interpolate import (
    ImageTransform, resize_bilinear, resize_nearest, resize_width,
    scale_bilinear, transform, transformed_size)
from taichi_image_tpu.ops.packed import decode12, decode16, encode12, encode16
from taichi_image_tpu.ops.tonemap import tonemap_linear, tonemap_reinhard
from taichi_image_tpu.ops.color import (
    rgb_gray, bgr_gray, rgb_yuv420_image, yuv420_rgb_image, split_yuv_420)
from taichi_image_tpu.utils import Bounds, bounds_from_np, bounds_to_np, lerp

__version__ = "0.1.0"
