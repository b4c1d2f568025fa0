"""End-to-end CLI tests: synthetic multi-camera scan -> tonemap_scan ->
JPEG grid outputs (reference scripts/tonemap_scan.py workflow)."""

import numpy as np
import pytest

from taichi_image_tpu.ops import packed
from taichi_image_tpu.scripts import util as sutil
from conftest import make_test_rgb
from oracle import rgb_to_bayer_oracle


def _write_scan(tmp_path, n_cams=2, n_frames=3, h=64, w=96):
  tmp_path.mkdir(parents=True, exist_ok=True)
  for cam in range(n_cams):
    d = tmp_path / f"cam{cam}"
    d.mkdir()
    for f in range(n_frames):
      img = make_test_rgb(h, w, seed=cam * 10 + f)
      cfa = rgb_to_bayer_oracle(img, "RGGB")
      raw = np.asarray(packed.encode12(cfa, scaled=True))
      (d / f"frame{f:03d}.raw").write_bytes(raw.tobytes())
  return tmp_path


def test_natsorted():
  assert sutil.natsorted(["f10", "f2", "f1"]) == ["f1", "f2", "f10"]


def test_find_scan_folders(tmp_path):
  _write_scan(tmp_path)
  folders, names = sutil.find_scan_folders(tmp_path)
  assert len(folders) == 2
  assert names == ["frame000.raw", "frame001.raw", "frame002.raw"]


def test_load_images_iter(tmp_path):
  _write_scan(tmp_path, n_cams=2, n_frames=3)
  folders, names = sutil.find_scan_folders(tmp_path)
  seen = list(sutil.load_images_iter(sutil.load_raw_bytes, folders, names))
  assert [n for n, _ in seen] == names
  for _, group in seen:
    assert len(group) == 2
    for arr in group.values():
      assert arr.dtype == np.uint8


def test_concat_image_grid():
  imgs = [np.full((4, 6, 3), i, np.uint8) for i in range(4)]
  grid = sutil.concat_image_grid(imgs, rows=2)
  assert grid.shape == (8, 12, 3)
  assert grid[0, 0, 0] == 0 and grid[0, 11, 0] == 1
  assert grid[7, 0, 0] == 2 and grid[7, 11, 0] == 3


def test_tonemap_scan_end_to_end(tmp_path):
  pytest.importorskip("PIL")
  scan = _write_scan(tmp_path / "scan", h=64, w=96)
  out = tmp_path / "out"
  from taichi_image_tpu.scripts.tonemap_scan import main
  main(["--scan", str(scan), "--width", "96", "--resize_width", "48",
        "--write", str(out), "--transform", "none", "--rows", "1"])
  files = sorted(out.glob("*.jpg"))
  assert len(files) == 3
  from PIL import Image
  img = np.asarray(Image.open(files[0]))
  # 2 cameras side by side, resized to width 48 (height 32)
  assert img.shape == (32, 96, 3)
  assert img.std() > 5  # not a blank image


def test_tonemap_scan_serial_matches_pipelined(tmp_path):
  """--pipeline_depth 0 (the serial round-3 driver) writes the same
  JPEGs as the pipelined default (pipelining only reorders host work;
  the EMA chain order is identical)."""
  pytest.importorskip("PIL")
  scan = _write_scan(tmp_path / "scan", h=64, w=96)
  out_p, out_s = tmp_path / "outp", tmp_path / "outs"
  from taichi_image_tpu.scripts.tonemap_scan import main
  base = ["--scan", str(scan), "--width", "96", "--resize_width", "48",
          "--transform", "none", "--rows", "1"]
  main(base + ["--write", str(out_p)])
  main(base + ["--write", str(out_s), "--pipeline_depth", "0"])
  for f in sorted(out_p.glob("*.jpg")):
    assert (out_s / f.name).read_bytes() == f.read_bytes()


def test_tonemap_scan_i420_fetch(tmp_path):
  """--fetch yuv420 halves the D2H bytes (the device emits fused I420;
  JPEG encodes natively from YCbCr) and stays close to the RGB-fetch
  output: JPEG is itself YCbCr 4:2:0, so the only differences are the
  ISP's BT.601 matrix quirks vs libjpeg's and the nearest (vs fancy)
  chroma upsample."""
  pytest.importorskip("PIL")
  from PIL import Image
  scan = _write_scan(tmp_path / "scan", h=64, w=96)
  out_rgb, out_yuv = tmp_path / "outr", tmp_path / "outy"
  from taichi_image_tpu.scripts.tonemap_scan import main
  base = ["--scan", str(scan), "--width", "96", "--resize_width", "48",
          "--transform", "none", "--rows", "1"]
  main(base + ["--write", str(out_rgb)])
  main(base + ["--write", str(out_yuv), "--fetch", "yuv420"])
  files = sorted(out_yuv.glob("*.jpg"))
  assert len(files) == 3
  for f in files:
    a = np.asarray(Image.open(out_rgb / f.name)).astype(np.float64)
    b = np.asarray(Image.open(f)).astype(np.float64)
    assert a.shape == b.shape == (32, 96, 3)
    mse = ((a - b) ** 2).mean()
    psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-9))
    assert psnr > 30, f"{f.name}: {psnr:.1f} dB"


def test_tonemap_images_end_to_end(tmp_path):
  pytest.importorskip("PIL")
  from PIL import Image
  d = tmp_path / "imgs"
  d.mkdir()
  for i in range(2):
    img = make_test_rgb(32, 48, seed=i)
    cfa = (rgb_to_bayer_oracle(img, "RGGB") * 65535).astype(np.uint16)
    Image.fromarray(cfa).save(str(d / f"im{i}.png"))
  out = tmp_path / "out"
  from taichi_image_tpu.scripts.tonemap_images import main
  main([str(d), "--write", str(out)])
  assert len(list(out.glob("*.jpg"))) == 2


def test_compare_bayer_cli(tmp_path, capsys):
  pytest.importorskip("PIL")
  from PIL import Image
  img = (make_test_rgb(48, 64) * 255).astype(np.uint8)
  p = tmp_path / "rgb.png"
  Image.fromarray(img).save(str(p))
  from taichi_image_tpu.scripts.compare_bayer import main
  main([str(p)])
  out = capsys.readouterr().out
  assert "RGGB" in out and "BGGR" in out


def test_compare_bayer_write_and_headless_show(tmp_path, capsys):
  """--write saves per-pattern/method PNGs; --show falls back to
  writing on a headless host (the reference's interactive harness,
  test/bayer.py:34-41)."""
  pytest.importorskip("PIL")
  from PIL import Image
  img = (make_test_rgb(48, 64) * 255).astype(np.uint8)
  p = tmp_path / "rgb.png"
  Image.fromarray(img).save(str(p))
  from taichi_image_tpu.scripts.compare_bayer import main
  out = tmp_path / "imgs"
  main([str(p), "--write", str(out)])
  pngs = sorted(f.name for f in out.glob("*.png"))
  assert "RGGB_mhc.png" in pngs and "BGGR_bilinear.png" in pngs
  assert len(pngs) == 8  # 4 patterns x 2 methods
  # round-trip: the written PNG is the demosaic output, not garbage
  back = np.asarray(Image.open(str(out / "RGGB_mhc.png")))
  assert back.shape == (48, 64, 3) and back.std() > 1.0
  # --show on this display-less host must not raise; it redirects to
  # --write's directory (or a default) and says so
  main([str(p), "--show", "--write", str(out)])
  msg = capsys.readouterr().out
  assert "unavailable" in msg or "wrote" in msg


def test_tonemap_scan_debug_flag(tmp_path, monkeypatch):
  """--debug turns on the checkify validation path (reference --debug ->
  ti.init(debug=True), test/arguments.py:7,27) and clean data passes."""
  pytest.importorskip("PIL")
  # setenv registers the restore-to-original undo, so the CLI's direct
  # os.environ write below is rolled back after the test (a plain
  # delenv(raising=False) on an absent var registers NO undo and the
  # flag would leak into every later test).
  monkeypatch.setenv("TAICHI_IMAGE_TPU_DEBUG", "0")
  scan = _write_scan(tmp_path / "scan", h=64, w=96, n_frames=1)
  out = tmp_path / "out"
  from taichi_image_tpu.scripts.tonemap_scan import main
  main(["--scan", str(scan), "--width", "96", "--write", str(out),
        "--transform", "none", "--rows", "1", "--debug"])
  import os
  assert os.environ.get("TAICHI_IMAGE_TPU_DEBUG") == "1"
  assert len(sorted(out.glob("*.jpg"))) == 1


def test_example_camera_rig(tmp_path):
  """examples/camera_rig.py runs end-to-end (streaming + I420 +
  checkpoint branches)."""
  pytest.importorskip("PIL")
  import pathlib
  root = pathlib.Path(__file__).parent.parent
  import runpy
  import sys
  argv = sys.argv
  sys.argv = ["camera_rig.py", "--frames", "2", "--cameras", "2",
              "--height", "64", "--width", "96",
              "--out", str(tmp_path / "rig")]
  try:
    runpy.run_path(str(root / "examples" / "camera_rig.py"),
                   run_name="__main__")
  finally:
    sys.argv = argv
  assert len(list((tmp_path / "rig").glob("*.jpg"))) == 2


@pytest.mark.parametrize("entry", ["bench", "camera_isp", "bayer",
                                   "interpolate"])
def test_benchmarks_refuse_without_gpu(entry, capsys):
  """Every timing entry point fails on a machine without a GPU instead
  of timing the CPU, and prints no result."""
  import importlib
  import pathlib
  import sys
  if entry == "bench":
    sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
    mod = importlib.import_module("bench")
    run = mod.main
  else:
    mod = importlib.import_module(f"taichi_image_tpu.bench.{entry}")
    run = lambda: mod.main([])
  with pytest.raises(RuntimeError, match="GPU is required"):
    run()
  assert "frames" not in capsys.readouterr().out
