"""Run the fused ISP once, at full size, on one NVIDIA GPU and check it.

    python chip_smoke.py           # phases D1, D2, D3, D5, oracle, stages
    python chip_smoke.py --four    # only the four-card meshes

Phases (one process, the card opened once; any failure ends the run
with a traceback and a non-zero exit):

  D1      Camera16 (f16, the reference default) on 6 x 3840x2160 RGGB
          packed12 from host bytes: three ``ISP.process`` sets with the
          EMA metering state carried; the step's memory analysis.
  D2      CameraBF16 and Camera32 at D1's shapes; Camera32 again with
          I420 output.
  D3      the production ``tonemap_scan`` shape: Camera32, resize to
          1920 wide, rot90, gamma 0.9, intensity 3.0, three sets through
          ``process_stream`` from host bytes to host frames.
  D5      ``process_large`` on 6 x 7680x4320, against ``ISP.process`` on
          the same input on the card (<= 1 u8 count).
  oracle  2 x 128x192 through the numpy oracle chain of tests/oracle.py.
  stages  a profiler trace of the Camera16 and CameraBF16 steps reduced
          to device time and logical bytes per named stage, beside the
          rate of a large bf16 copy.

D1-D3 compare their first set with the same jitted function run on the
host CPU in this process: u8 within 1 count, metrics within 1e-5
relative for f32/bf16 (f16 at its own resolution, 1e-3).

``--four`` runs only 24 x 4K Camera32 over a 4-card camera mesh and
2 x 8K over a 4-card row mesh, each against the unsharded step on one
card (metrics 1e-5, u8 <= 1 count).

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_CAM, H4K, W4K = 6, 2160, 3840
H8K, W8K = 4320, 7680


def card_line() -> str:
  """``name, power.limit`` of the first card, as nvidia-smi reports it."""
  res = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True,
      check=True, timeout=60)
  return res.stdout.strip().splitlines()[0]


def packed12_raws(n, h, w, seed):
  """Seeded packed12 frame bytes: a smooth scene mosaicked to RGGB with
  sensor noise, so metering and tonemap see realistic statistics."""
  rng = np.random.default_rng(seed)
  yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
  xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
  out = np.empty((n, h, w * 3 // 2), np.uint8)
  for i in range(n):
    base = 0.45 + 0.3 * np.sin(6.0 * xx + 2.0 * i) * np.cos(4.0 * yy)
    cfa = base + rng.normal(0.0, 0.03, (h, w)).astype(np.float32)
    cfa[0::2, 0::2] *= 0.8   # R sites
    cfa[1::2, 1::2] *= 0.6   # B sites
    v = np.clip(cfa * 4095.0, 0, 4095).astype(np.uint16).reshape(h, -1, 2)
    p0, p1 = v[..., 0], v[..., 1]
    out[i] = np.stack([p0 & 0xFF, ((p1 & 0xF) << 4) | (p0 >> 8), p1 >> 4],
                      axis=-1).reshape(h, -1).astype(np.uint8)
  return out


def compare(name, got, want, metrics_got, metrics_want, rtol,
            bf16_step=False):
  """Assert u8 within 1 count and metrics within ``rtol``; print both.

  ``bf16_step``: the pipeline stores the mapped ``p`` in bf16, whose
  step near the frame maximum is 2**-8 / max(p), about 1.25 u8 counts.
  Where two implementations' f32 ``p`` differ by an ulp across a bf16
  rounding boundary the pixel moves by one such step, 2 counts after
  truncation; up to 1e-4 of the pixels may do so."""
  import jax
  worst, share, share2 = 0, 0.0, 0.0
  for a, b in zip(jax.tree_util.tree_leaves(got),
                  jax.tree_util.tree_leaves(want)):
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
      raise AssertionError(f"{name}: output {a.shape}/{a.dtype} != "
                           f"reference {b.shape}/{b.dtype}")
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    worst = max(worst, int(d.max()))
    share = max(share, float((d > 0).mean()))
    share2 = max(share2, float((d > 1).mean()))
  mg, mw = np.asarray(metrics_got), np.asarray(metrics_want)
  rel = float(np.max(np.abs(mg - mw) / np.maximum(np.abs(mw), 1e-3)))
  print(f"  {name}: u8 max diff {worst}, share off {share:.2e}, share "
        f"off by 2 {share2:.2e}, metrics max rel diff {rel:.2e} (limit "
        f"{rtol:g})", flush=True)
  if worst > (2 if bf16_step else 1) or (bf16_step and share2 > 1e-4):
    raise AssertionError(f"{name}: u8 differs by {worst} counts on "
                         f"{share2:.2e} of the pixels")
  if not np.all(np.isfinite(mg)) or rel > rtol:
    raise AssertionError(f"{name}: metrics differ by {rel:.3g} relative")


def _metrics_rtol(isp):
  from taichi_image_tpu import types
  return 1e-3 if isp._work_dtype == types.f16 else 1e-5


def _step_args(isp, raws, **kw):
  """The arguments ``ISP.process`` hands its jitted step."""
  import jax.numpy as jnp
  prev = isp.metrics if isp.metrics is not None else jnp.zeros(9,
                                                               jnp.float32)
  t = 0.0 if isp.metrics is None else 1.0 - isp.moving_alpha
  return (jnp.asarray(raws), jnp.array(prev), jnp.float32(t),
          float(kw.get("gamma", 1.0)), float(kw.get("intensity", 1.0)),
          1.0, 0.0, "packed12", False, isp._work_dtype, isp.bayer_pattern,
          isp._cc_tuple(), isp._resize_plan_key(raws, "packed12"),
          isp.metering_stride, isp.transform, "reinhard")


def _fused_step_lowering(args, color_format="rgb"):
  from taichi_image_tpu.models import camera_isp
  return camera_isp._jit_fused_step.lower(*args, color_format=color_format)


def compiled_step(isp, raws, color_format="rgb", **kw):
  """The compiled program ``ISP.process`` runs for these arguments."""
  return _fused_step_lowering(_step_args(isp, raws, **kw),
                              color_format).compile()


def memory_line(compiled) -> str:
  m = compiled.memory_analysis()
  if m is None:
    return "memory analysis: not available"
  return (f"memory analysis: arguments {m.argument_size_in_bytes / 2**20:.1f}"
          f" MiB, outputs {m.output_size_in_bytes / 2**20:.1f} MiB, "
          f"temporaries {m.temp_size_in_bytes / 2**20:.1f} MiB")


def run_sets(isp, sets, card, label, **kw):
  """``isp.process`` over host frame sets with the EMA carried; prints
  the wall time of each set, host bytes to device output, and returns
  [(output, metrics after the set)]."""
  import jax
  results, times = [], []
  for raws in sets:
    t0 = time.perf_counter()
    out = jax.block_until_ready(isp.process(raws, **kw))
    times.append(time.perf_counter() - t0)
    results.append((out, np.asarray(isp.metrics)))
  print(f"  {label}: wall per set " + ", ".join(f"{s * 1e3:.2f} ms"
                                                for s in times)
        + f" (first includes compilation) [{card}]", flush=True)
  return results


def cpu_reference(cls, sets0, ref_device, isp_kwargs=None, **kw):
  """(metrics, output) of a fresh ``cls`` ISP on ``ref_device`` for the
  first frame set."""
  import jax
  with jax.default_device(ref_device):
    ref = cls(_pattern(), **(isp_kwargs or {}))
    out = jax.block_until_ready(ref.process(sets0, **kw))
    return np.asarray(ref.metrics), jax.tree_util.tree_map(np.asarray, out)


def _pattern():
  from taichi_image_tpu.ops.bayer import BayerPattern
  return BayerPattern.RGGB


def phase_classes(card, ref_device, n=N_CAM, h=H4K, w=W4K):
  """D1 and D2: Camera16 (three sets, EMA carried), CameraBF16, Camera32
  and Camera32 with I420 output, each checked against ``ref_device``."""
  from taichi_image_tpu.models.camera_isp import (Camera16, Camera32,
                                                  CameraBF16)
  sets = [packed12_raws(n, h, w, seed) for seed in range(3)]
  cases = [("D1 Camera16", Camera16, {}, 3),
           ("D2 CameraBF16", CameraBF16, {}, 1),
           ("D2 Camera32", Camera32, {}, 1),
           ("D2 Camera32 yuv420", Camera32, {"color_format": "yuv420"}, 1)]
  for label, cls, kw, n_sets in cases:
    print(f"{label}: {n} x {w}x{h} packed12", flush=True)
    isp = cls(_pattern())
    print("  " + memory_line(compiled_step(isp, sets[0], **kw)), flush=True)
    results = run_sets(isp, sets[:n_sets], card, label, **kw)
    if not np.all(np.isfinite(results[-1][1])):
      raise AssertionError(f"{label}: EMA metrics not finite: "
                           f"{results[-1][1]}")
    m_ref, out_ref = cpu_reference(cls, sets[0], ref_device, **kw)
    compare(f"{label} card vs {ref_device.platform}", results[0][0],
            out_ref, results[0][1], m_ref, _metrics_rtol(isp),
            bf16_step=cls is CameraBF16)


def phase_scan(card, ref_device, n=N_CAM, h=H4K, w=W4K, resize_width=1920):
  """D3: the tonemap_scan configuration through ``process_stream``."""
  from taichi_image_tpu.models.camera_isp import Camera32
  from taichi_image_tpu.ops.interpolate import ImageTransform
  cfg = dict(resize_width=resize_width, transform=ImageTransform.rotate_90)
  kw = dict(gamma=0.9, intensity=3.0)
  sets = [packed12_raws(n, h, w, seed) for seed in range(3)]
  print(f"D3 Camera32 tonemap_scan: {n} x {w}x{h} -> {resize_width} wide, "
        "rot90, process_stream", flush=True)
  isp = Camera32(_pattern(), **cfg)
  t0 = time.perf_counter()
  frames = list(isp.process_stream(iter(sets), layout="hwc", **kw))
  dt = time.perf_counter() - t0
  print(f"  D3: {len(frames)} sets host bytes -> host frames in "
        f"{dt * 1e3:.2f} ms (includes compilation) [{card}]", flush=True)
  if len(frames) != 3 or frames[0].shape[0] != n:
    raise AssertionError(f"D3: got {len(frames)} sets of "
                         f"{frames[0].shape if frames else None}")
  first = Camera32(_pattern(), **cfg)
  first.process(sets[0], **kw)
  m_ref, out_ref = cpu_reference(Camera32, sets[0], ref_device, cfg,
                                 layout="hwc", **kw)
  compare(f"D3 card vs {ref_device.platform}", frames[0], out_ref,
          first.metrics, m_ref, 1e-5)


def phase_large(card, n=N_CAM, h=H8K, w=W8K):
  """D5: ``process_large`` against ``ISP.process`` on the same input."""
  import jax
  import jax.numpy as jnp
  from taichi_image_tpu.models import large
  from taichi_image_tpu.models.camera_isp import Camera16
  raws = jax.device_put(packed12_raws(n, h, w, seed=7))
  print(f"D5 Camera16: {n} x {w}x{h} packed12", flush=True)
  a, b = Camera16(_pattern()), Camera16(_pattern())
  print("  process: " + memory_line(compiled_step(a, raws)), flush=True)
  t0 = time.perf_counter()
  want = jax.block_until_ready(a.process(raws))
  t1 = time.perf_counter()
  got = jax.block_until_ready(b.process_large(raws))
  t2 = time.perf_counter()
  print(f"  D5: process {(t1 - t0) * 1e3:.2f} ms, process_large "
        f"{(t2 - t1) * 1e3:.2f} ms (both include compilation) [{card}]",
        flush=True)
  hh, wh = h // 2, w // 2
  # the scan driver's band for process_large's defaults (n_bands=4,
  # metering stride 8 -> 16-row band quantum)
  b_scan = large.scan_band_size(hh, 4, 16)
  if b_scan is not None:
    scan = large._banded_scan_step.lower(
        raws, jnp.zeros(9, jnp.float32), jnp.float32(0), b_scan,
        "packed12", False, b._work_dtype, _pattern(), None, 8, 1.0, 1.0,
        0.0, "reinhard").compile()
    print(f"  process_large scan step ({hh // b_scan} bands of {b_scan} "
          f"phase rows x {wh}): " + memory_line(scan), flush=True)
  compare("D5 process_large vs process", got, want, b.metrics, a.metrics,
          1e-3)


def phase_oracle(card, n=2, h=128, w=192):
  """The numpy oracle chain of tests/oracle.py on the card's output."""
  sys.path.insert(0, str(ROOT / "tests"))
  from oracle import isp_chain_oracle
  from taichi_image_tpu import types
  from taichi_image_tpu.models.camera_isp import Camera16, Camera32
  raws = packed12_raws(n, h, w, seed=11)
  for cls, wd in ((Camera32, types.f32), (Camera16, types.f16)):
    isp = cls(_pattern(), moving_alpha=0.2)
    for t_set in range(2):
      prev = (np.zeros(9, np.float32) if isp.metrics is None
              else np.asarray(isp.metrics))
      t = 0.0 if isp.metrics is None else 0.8
      out = np.asarray(isp.process(raws, gamma=0.9, intensity=2.0))
      m_want, want = isp_chain_oracle(raws, prev, t, work_dtype=wd,
                                      gamma=0.9, intensity=2.0)
      compare(f"oracle {cls.__name__} set {t_set} {n} x {w}x{h}", out,
              want, isp.metrics, m_want, 1e-3)
  print(f"  oracle: passed [{card}]", flush=True)


def copy_rate(shape=(N_CAM, 12, H4K // 2, W4K // 2), iters=20):
  """Bytes per second of a large bf16 read-plus-write on the card."""
  import jax
  import jax.numpy as jnp
  x = jnp.ones(shape, jnp.bfloat16)
  f = jax.jit(lambda v: v + jnp.bfloat16(1))
  y = jax.block_until_ready(f(x))
  t0 = time.perf_counter()
  for _ in range(iters):
    y = f(y)
  jax.block_until_ready(y)
  return 2 * x.nbytes * iters / (time.perf_counter() - t0)


def phase_stages(card, out_dir, n=N_CAM, h=H4K, w=W4K, steps=3):
  """Device time and logical bytes per named stage of the Camera16 and
  CameraBF16 steps, each from its own profiler trace of ``steps`` warm
  sets; the rate of a large bf16 copy beside them.

  The traced program is ``ISP.process``'s step compiled without CUDA
  command buffers: XLA otherwise launches the step's kernels as one
  graph, which the trace shows as a single event. The kernels are the
  same; only their launch differs."""
  import jax
  import jax.numpy as jnp
  from taichi_image_tpu.models.camera_isp import Camera16, CameraBF16
  from taichi_image_tpu.utils import stages
  out_dir.mkdir(parents=True, exist_ok=True)
  raws = jax.device_put(packed12_raws(n, h, w, seed=3))
  plane = "/device:GPU" if jax.default_backend() == "gpu" else "/host:CPU"
  rate = copy_rate((n, 12, h // 2, w // 2))
  print(f"stages: bf16 copy {rate / 1e9:.1f} GB/s (read + write) [{card}]",
        flush=True)
  nbytes = stages.stage_bytes(n, h, w, 2)
  for cls in (Camera16, CameraBF16):
    args = _step_args(cls(_pattern()), raws)
    compiled = _fused_step_lowering(args).compile(
        compiler_options={"xla_gpu_enable_command_buffer": ""})
    text = compiled.as_text()
    (out_dir / f"{cls.__name__}.hlo.txt").write_text(text)
    t = jnp.float32(0.9)
    m, _ = jax.block_until_ready(compiled(args[0], args[1], t))
    trace_dir = str(out_dir / f"trace_{cls.__name__}")
    with jax.profiler.trace(trace_dir):
      for _ in range(steps):
        m, _ = jax.block_until_ready(compiled(args[0], m, t))
    module, table = stages.scope_table(text)
    events = [e for e in stages.device_events(stages.trace_file(trace_dir),
                                              plane) if e[3] == module]
    if not events:
      raise AssertionError(f"stages: no kernel of {module} in the trace")
    per = stages.stage_times(events, [text])
    total = sum(per.values())
    print(f"  {cls.__name__} step: kernel time {total / steps / 1e6:.3f} ms"
          f" per set, busy {stages.busy_ns(events) / steps / 1e6:.3f} ms, "
          f"{len(events) // steps} kernels [{card}]", flush=True)
    for s, ns in per.items():
      sec = ns / steps / 1e9
      b = nbytes.get(s, 0)
      if not sec and not b:
        continue
      gbs = b / sec / 1e9 if sec > 0 else float("nan")
      print(f"    {s:9s} {sec * 1e3:8.3f} ms  {100 * ns / total:5.1f}%  "
            f"{b / 1e6:9.1f} MB  {gbs:8.1f} GB/s  "
            f"{100 * gbs * 1e9 / rate:5.1f}% of copy", flush=True)
    kernels = {}
    for e in events:
      kernels[e[4]] = kernels.get(e[4], 0) + e[2]
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    print("    largest kernels: " + ", ".join(
        f"{k} ({table.get(k, 'other')}) {v / steps / 1e6:.3f} ms"
        for k, v in top), flush=True)


def phase_four(card, n=24, hw=(H4K, W4K), hw8=(H8K, W8K)):
  """``n`` x 4K Camera32 over a 4-card camera mesh and 2 x 8K over a
  4-card row mesh, each against the unsharded step on one card."""
  import jax
  import jax.numpy as jnp
  sys.path.insert(0, str(ROOT))
  from __graft_entry__ import _check_against_unsharded
  from taichi_image_tpu import types
  from taichi_image_tpu.models.camera_isp import Camera32
  from taichi_image_tpu.parallel import (make_camera_mesh, replicate,
                                         shard_cameras, sharded_step_for_isp,
                                         spatial)
  from jax.sharding import Mesh
  devs = jax.devices()
  if len(devs) < 4:
    raise RuntimeError(f"--four needs 4 devices, found {len(devs)}")
  scalars = [jnp.float32(v) for v in (0.0, 1.0, 1.0, 1.0, 0.0)]

  def check_spread(name, arr):
    ds = {s.device for s in arr.addressable_shards}
    print(f"  {name}: shards on {sorted(d.id for d in ds)}", flush=True)
    if len(ds) != 4:
      raise AssertionError(f"{name}: output spans {len(ds)} devices, not 4")

  raws = packed12_raws(n, *hw, seed=21)
  mesh = make_camera_mesh(4)
  isp = Camera32(_pattern())
  step = sharded_step_for_isp(isp, mesh, raws.shape)
  r_sh = shard_cameras(raws, mesh)
  check_spread("camera mesh input", r_sh)
  m, out = jax.block_until_ready(step(r_sh, replicate(jnp.zeros(9), mesh),
                                      *scalars))
  t0 = time.perf_counter()
  m, out = jax.block_until_ready(step(r_sh, replicate(jnp.zeros(9), mesh),
                                      *scalars))
  dt = time.perf_counter() - t0
  check_spread("camera mesh output", out)
  ref = Camera32(_pattern())
  with jax.default_device(devs[0]):
    ref_out = jax.block_until_ready(ref.process(raws))
  print(f"  camera mesh: {n} x {hw[1]}x{hw[0]} Camera32 step "
        f"{dt * 1e3:.2f} ms (warm) [{card}]", flush=True)
  _check_against_unsharded(f"camera-mesh {n} cameras", (m, out),
                           (ref.metrics, ref_out))

  raws8 = packed12_raws(2, *hw8, seed=22)
  rmesh = Mesh(np.array(devs[:4]), ("rows",))
  sstep = spatial.make_spatial_isp_step(
      rmesh, fmt="packed12", work_dtype=types.f32, pattern=_pattern(),
      n_cameras=2, image_hw=hw8)
  r8 = spatial.shard_rows(raws8, rmesh)
  check_spread("row mesh input", r8)
  m8, out8 = jax.block_until_ready(sstep(r8, jnp.zeros(9, jnp.float32),
                                         *scalars))
  t0 = time.perf_counter()
  m8, out8 = jax.block_until_ready(sstep(r8, jnp.zeros(9, jnp.float32),
                                         *scalars))
  dt = time.perf_counter() - t0
  check_spread("row mesh output", out8)
  ref8 = Camera32(_pattern())
  with jax.default_device(devs[0]):
    ref8_out = jax.block_until_ready(ref8.process(raws8))
  print(f"  row mesh: 2 x {hw8[1]}x{hw8[0]} Camera32 step "
        f"{dt * 1e3:.2f} ms (warm) [{card}]", flush=True)
  _check_against_unsharded("row-mesh 2 cameras", (m8, out8),
                           (ref8.metrics, ref8_out))


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--four", action="store_true",
                  help="run only the four-card camera and row meshes")
  ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" /
                  "chip_smoke", help="directory for the profiler trace")
  args = ap.parse_args(argv)

  from taichi_image_tpu.utils.device import (enable_compile_cache,
                                             require_gpu)
  devs = require_gpu()
  print(f"compile cache: {enable_compile_cache()}", flush=True)
  card = card_line()
  print(card, flush=True)
  import jax
  print(f"jax {jax.__version__}, devices: {devs}", flush=True)
  t_start = time.perf_counter()
  if args.four:
    phase_four(card)
  else:
    ref = jax.devices("cpu")[0]
    phase_oracle(card)
    phase_classes(card, ref)
    phase_scan(card, ref)
    phase_large(card)
    phase_stages(card, args.out)
  print(f"all phases passed in {time.perf_counter() - t_start:.1f} s "
        f"[{card}]", flush=True)
  print(card, flush=True)
  d = jax.devices()[0]
  print(json.dumps({"ok": True, "device": {
      "platform": d.platform, "kind": d.device_kind,
      "count": len(jax.devices())}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
