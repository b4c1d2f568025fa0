"""The GPU requirement, the compile-cache placement, the stage-trace
reduction, and chip_smoke.py's phases at tiny shapes on the CPU."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from taichi_image_tpu.utils import device, stages

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


@pytest.fixture
def cache_config():
  """Restore JAX's compile-cache setting after the test."""
  before = jax.config.jax_compilation_cache_dir
  yield
  jax.config.update("jax_compilation_cache_dir", before)


def test_require_gpu_raises_on_cpu():
  with pytest.raises(RuntimeError, match="GPU is required"):
    device.require_gpu()


def test_compile_cache_fixed_path_in_checkout(monkeypatch, cache_config):
  monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
  first = device.enable_compile_cache()
  assert first == device.enable_compile_cache()
  assert Path(first) == ROOT / ".jax_cache"
  assert jax.config.jax_compilation_cache_dir == first
  ignored = (ROOT / ".gitignore").read_text().split()
  assert ".jax_cache/" in ignored


def test_compile_cache_env_wins(monkeypatch, tmp_path, cache_config):
  monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
  jax.config.update("jax_compilation_cache_dir", None)
  assert device.enable_compile_cache() == str(tmp_path)
  assert device.enable_compile_cache() == str(tmp_path)
  # the variable is JAX's own: the code sets nothing in its place
  assert jax.config.jax_compilation_cache_dir is None


def test_chip_smoke_refuses_on_cpu(capsys):
  with pytest.raises(RuntimeError, match="GPU is required"):
    chip_smoke.main([])
  assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_alone_fails(tmp_path):
  """Without the rest of the repository the script cannot import the
  package, and exits non-zero with no result line."""
  (tmp_path / "chip_smoke.py").write_text(
      (ROOT / "chip_smoke.py").read_text())
  res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
  assert res.returncode != 0
  assert '"ok"' not in res.stdout


def test_packed12_raws_decode_to_the_scene():
  from oracle import decode12_oracle
  raws = chip_smoke.packed12_raws(2, 8, 12, seed=0)
  assert raws.shape == (2, 8, 18) and raws.dtype == np.uint8
  codes = decode12_oracle(raws[0])
  assert codes.shape == (8, 12) and codes.max() <= 4095
  assert 0.2 < codes.mean() / 4095 < 0.6


def test_compare_contract():
  a = np.zeros((2, 3, 4, 4), np.uint8)
  m = np.ones(9, np.float32)
  chip_smoke.compare("same", a, a + 1, m, m, 1e-5)
  with pytest.raises(AssertionError, match="counts"):
    chip_smoke.compare("two", a, a + 2, m, m, 1e-5)
  with pytest.raises(AssertionError, match="metrics"):
    chip_smoke.compare("metrics", a, a, m * 1.01, m, 1e-5)
  with pytest.raises(AssertionError, match="reference"):
    chip_smoke.compare("shape", a, a[:1], m, m, 1e-5)


def test_phase_oracle_tiny(capsys):
  chip_smoke.phase_oracle("cpu", n=2, h=16, w=24)
  assert "oracle: passed" in capsys.readouterr().out


def test_phase_classes_tiny(capsys):
  chip_smoke.phase_classes("cpu", jax.devices("cpu")[0], n=2, h=32, w=48)
  out = capsys.readouterr().out
  for label in ("D1 Camera16", "D2 CameraBF16", "D2 Camera32 yuv420"):
    assert f"{label} card vs cpu: u8 max diff" in out


def test_phase_scan_tiny(capsys):
  chip_smoke.phase_scan("cpu", jax.devices("cpu")[0], n=2, h=32, w=48,
                        resize_width=24)
  assert "D3 card vs cpu" in capsys.readouterr().out


def test_phase_large_tiny(capsys):
  chip_smoke.phase_large("cpu", n=1, h=128, w=96)
  out = capsys.readouterr().out
  assert "D5 process_large vs process: u8 max diff" in out
  assert "process_large scan step" in out


def test_phase_stages_tiny(tmp_path, capsys):
  chip_smoke.phase_stages("cpu", tmp_path, n=1, h=32, w=48, steps=1)
  out = capsys.readouterr().out
  for s in ("decode", "demosaic", "map_max", "finish"):
    assert f"    {s} " in out


def test_phase_four_on_virtual_devices(capsys):
  """The --four phase on four of the test session's virtual CPU devices:
  both meshes spread over four devices and match the unsharded step."""
  chip_smoke.phase_four("cpu", n=8, hw=(32, 48), hw8=(64, 48))
  out = capsys.readouterr().out
  assert "camera mesh output: shards on [0, 1, 2, 3]" in out
  assert "row mesh output: shards on [0, 1, 2, 3]" in out
  assert out.count("— ok") == 2


def test_stage_of_scope_paths():
  assert stages.stage_of("jit(_jit_fused_step)/demosaic/conv") == "demosaic"
  assert stages.stage_of("jit(f)/jit(g)/map_max/finish/mul") == "finish"
  assert stages.stage_of("jit(f)/add") == "other"


def test_scope_table_attributes_fusions():
  text = "\n".join([
      "HloModule jit_step, entry_computation_layout={}",
      "%fused_a (p: f32[4], /*index=1*/q: f32[4]) -> f32[4] {",
      '  ROOT %m = f32[4]{0} multiply(%p, %p), metadata={op_name='
      '"jit(step)/decode/mul"}',
      "}",
      "ENTRY %main (x: f32[4]) -> f32[4] {",
      "  %x = f32[4]{0} parameter(0)",
      "  %fusion.1 = f32[4]{0} fusion(%x), kind=kLoop, calls=%fused_a",
      "  %convolution = f32[4]{0} convolution(%fusion.1, %x), window={}",
      '  %cudnn-conv.1 = (f32[4]{0}, u8[0]{0}) custom-call(%x), '
      'custom_call_target="__cudnn$convForward"',
      "  %copy.2 = f32[4]{0} copy(%convolution)",
      '  ROOT %add = f32[4]{0} add(%copy.2, %x), metadata={op_name='
      '"jit(step)/finish/add"}',
      "}"])
  module, table = stages.scope_table(text)
  assert module == "jit_step"
  assert table["fusion.1"] == "decode"
  assert table["convolution"] == "demosaic"
  assert table["cudnn-conv.1"] == "demosaic"
  assert table["copy.2"] == "finish"      # from its consumer
  assert table["add"] == "finish"


def test_busy_and_stage_times():
  ev = [("Stream #1", 0, 10, "m", "a"), ("Stream #1", 5, 10, "m", "b"),
        ("Stream #2", 30, 5, "m", "a"), ("Stream #2", 40, 5, "x", "a")]
  assert stages.busy_ns(ev) == 15 + 5 + 5
  text = ("HloModule m\nENTRY %e () -> f32[] {\n"
          '  %a = f32[] constant(0), metadata={op_name="j/meter/c"}\n'
          '  %b = f32[] constant(1), metadata={op_name="j/i420/c"}\n}')
  per = stages.stage_times(ev, [text])
  assert per["meter"] == 15 and per["i420"] == 10 and per["other"] == 0


def test_stage_bytes_model():
  b = stages.stage_bytes(6, 2160, 3840, 2)
  px = 6 * 2160 * 3840
  assert b["decode"] == px * 3 // 2 + 2 * px
  assert b["map_max"] == 12 * px
  assert stages.stage_bytes(1, 4, 4, 4, "yuv420")["i420"] == 48 + 24


def test_device_events_reads_a_cpu_trace(tmp_path):
  f = jax.jit(lambda x: jnp.sin(x) * 2)
  x = jnp.ones((256, 256))
  f(x).block_until_ready()
  with jax.profiler.trace(str(tmp_path)):
    f(x).block_until_ready()
  events = stages.device_events(stages.trace_file(str(tmp_path)),
                                "/host:CPU")
  assert any(e[3].startswith("jit_") for e in events)
  assert stages.busy_ns(events) > 0


@pytest.fixture
def gpu():
  """The first GPU; skips where JAX has none (decided at run time, so
  every worker collects the same tests)."""
  try:
    return jax.devices("gpu")[0]
  except RuntimeError:
    pytest.skip("no GPU: chip_smoke.py runs this check on the card")


@pytest.mark.gpu
def test_oracle_chain_on_card(gpu):
  from oracle import isp_chain_oracle
  from taichi_image_tpu.models.camera_isp import Camera32
  from taichi_image_tpu.ops.bayer import BayerPattern
  raws = chip_smoke.packed12_raws(2, 32, 48, seed=1)
  with jax.default_device(gpu):
    isp = Camera32(BayerPattern.RGGB)
    out = np.asarray(isp.process(raws, gamma=0.9))
  m, want = isp_chain_oracle(raws, np.zeros(9, np.float32), 0.0,
                             gamma=0.9)
  chip_smoke.compare("card oracle", out, want, isp.metrics, m, 1e-3)
  assert json.dumps({"platform": gpu.platform})
