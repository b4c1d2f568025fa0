"""Per-stage device time from a profiler trace, and the logical bytes
each stage of the fused step must move.

The fused step (``models/camera_isp.fused_isp_step``) runs each stage
under a ``jax.named_scope`` listed in ``camera_isp.STAGES``. XLA keeps
that scope in the ``op_name`` metadata of every instruction it emits,
fusions included (a fusion carries its root's metadata). A device trace
names each kernel's HLO instruction (``hlo_op``) and program
(``hlo_module``), so joining the two attributes each kernel's device
time to one stage; kernels outside every scope count as ``other``.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, Iterable, List, Tuple

from taichi_image_tpu.models.camera_isp import STAGES

__all__ = ["stage_of", "scope_table", "trace_file", "device_events",
           "stage_times", "busy_ns", "stage_bytes"]

_INSTR = re.compile(
    r"^\s+(?:ROOT\s+)?%?([^\s=]+)\s*=\s*(?:\([^)]*\)|\S+)\s+([\w-]+)\(")
_OP_NAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"calls=%?([\w.-]+)")
_COMPUTATION = re.compile(r"^(?:ENTRY\s+)?%?([\w.-]+)\s.*\{\s*$")  # unindented
_MODULE = re.compile(r"^HloModule\s+([^\s,]+)")


def stage_of(op_name: str) -> str:
  """The innermost pipeline stage named in an ``op_name`` scope path
  (``jit(step)/demosaic/conv...`` -> ``demosaic``), else ``other``."""
  for part in reversed(op_name.split("/")):
    if part in STAGES:
      return part
  return "other"


def scope_table(hlo_text: str) -> Tuple[str, Dict[str, str]]:
  """(module name, {instruction name: stage}) from a compiled program's
  optimized HLO text (``jitted.lower(...).compile().as_text()``).

  Optimization passes drop the metadata of some instructions. A fusion
  without its own then takes the most common stage inside the
  computation it calls; a convolution without one (a cuDNN custom call
  on the GPU) is the demosaic stencil, the step's only convolution;
  anything else takes the stage of the instructions that consume it."""
  module, comp = "", ""
  instrs = []            # (name, opcode, stage or None, callee, operands)
  comp_stages: Dict[str, List[str]] = {}
  for line in hlo_text.splitlines():
    if not module:
      m = _MODULE.match(line)
      if m:
        module = m.group(1)
        continue
    m = _COMPUTATION.match(line)
    if m and not line[:1].isspace():
      comp = m.group(1)
      continue
    m = _INSTR.match(line)
    if not m:
      continue
    op = _OP_NAME.search(line)
    stage = stage_of(op.group(1)) if op else None
    if stage is not None and stage != "other":
      comp_stages.setdefault(comp, []).append(stage)
    callee = _CALLS.search(line)
    args = line[m.end():].split(")", 1)[0]
    opcode = m.group(2)
    if opcode == "custom-call" and "conv" in line:
      opcode = "convolution"
    instrs.append((m.group(1), opcode, stage,
                   callee.group(1) if callee else None,
                   re.findall(r"%([\w.-]+)", args)))
  table = {}
  for name, opcode, stage, callee, _ in instrs:
    if stage is None or stage == "other":
      inner = comp_stages.get(callee or "", [])
      if inner:
        stage = max(set(inner), key=inner.count)
      elif opcode == "convolution":
        stage = "demosaic"
      else:
        stage = "other"
    table[name] = stage
  users: Dict[str, List[str]] = {}
  for name, _, _, _, operands in instrs:
    for o in operands:
      users.setdefault(o, []).append(name)
  for name in table:
    if table[name] == "other":
      known = [table[u] for u in users.get(name, ())
               if table.get(u, "other") != "other"]
      if known:
        table[name] = max(set(known), key=known.count)
  return module, table


def trace_file(trace_dir: str) -> str:
  """The newest ``.xplane.pb`` that ``jax.profiler`` wrote under
  ``trace_dir``."""
  files = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                        "*", "*.xplane.pb")))
  if not files:
    raise FileNotFoundError(f"no profiler trace under {trace_dir}")
  return files[-1]


def device_events(path: str, plane_prefix: str = "/device:GPU"):
  """[(line name, start ns, duration ns, hlo_module, hlo_op)] of every
  event on the device planes that names an HLO instruction. Where a
  device plane has per-stream lines (``Stream ...``) only those are
  kept, so derived summary lines never count a kernel twice."""
  from jax.profiler import ProfileData
  out = []
  for plane in ProfileData.from_file(path).planes:
    if not plane.name.startswith(plane_prefix):
      continue
    rows = []
    for line in plane.lines:
      for ev in line.events:
        stats = dict(ev.stats)
        if "hlo_op" in stats:
          rows.append((line.name, int(ev.start_ns), int(ev.duration_ns),
                       str(stats.get("hlo_module", "")),
                       str(stats["hlo_op"])))
    if any(r[0].startswith("Stream") for r in rows):
      rows = [r for r in rows if r[0].startswith("Stream")]
    out.extend(rows)
  return out


def stage_times(events: Iterable, hlo_texts: Iterable[str]
                ) -> Dict[str, int]:
  """Summed device nanoseconds per stage (plus ``other``) of the events
  whose program is one of ``hlo_texts``; events of other programs are
  left out."""
  tables = dict(scope_table(t) for t in hlo_texts)
  out = {s: 0 for s in STAGES + ("other",)}
  for _, _, dur, module, op in events:
    table = tables.get(module)
    if table is None:
      continue
    out[table.get(op, "other")] += dur
  return out


def busy_ns(events: Iterable) -> int:
  """Length of the union of the events' intervals: the time in which
  at least one kernel ran."""
  spans: List[Tuple[int, int]] = sorted((s, s + d) for _, s, d, _, _
                                        in events)
  total, cur_s, cur_e = 0, None, None
  for s, e in spans:
    if cur_e is None or s > cur_e:
      if cur_e is not None:
        total += cur_e - cur_s
      cur_s, cur_e = s, e
    else:
      cur_e = max(cur_e, e)
  if cur_e is not None:
    total += cur_e - cur_s
  return total


def stage_bytes(n: int, h: int, w: int, work_bytes: int,
                color_format: str = "rgb") -> Dict[str, int]:
  """Logical bytes each stage of the no-resize fused step must read
  plus write for ``n`` packed12 frames of ``h`` x ``w`` pixels, with the
  working dtype ``work_bytes`` wide: what an implementation that keeps
  every stage's input and output in device memory exactly once moves.

    decode    R raw packed12       + W phases (n, 4, h/2, w/2)
    demosaic  R phases             + W x12 (n, 12, h/2, w/2)
    meter     R the stride-8 sample grid of 3 channels
    map_max   R x12                + W p (work dtype)
    finish    R p                  + W u8 (n, 3, h, w)
    i420      R u8 (n, 3, h, w)    + W Y + UV (1.5 bytes a pixel)
  """
  px = n * h * w
  out = {
      "decode": px * 3 // 2 + px * work_bytes,
      "demosaic": px * work_bytes + 3 * px * work_bytes,
      "meter": 3 * (px // 64) * work_bytes,
      "map_max": 2 * 3 * px * work_bytes,
      "finish": 3 * px * work_bytes + 3 * px,
      "resize": 0,
      "i420": 0,
  }
  if color_format == "yuv420":
    out["i420"] = 3 * px + px * 3 // 2
  return out
