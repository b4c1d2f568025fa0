"""What the measured entry points require of the process: a GPU, and
one fixed place for JAX's persistent compilation cache."""

from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = ["require_gpu", "enable_compile_cache", "REPO_CACHE_DIR"]

# Fixed path inside the checkout (listed in .gitignore). The cache key
# includes the path, so it must never depend on a temp name, a PID or
# the time.
REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def require_gpu():
  """Return ``jax.devices()``; raise ``RuntimeError`` unless JAX's
  default backend is the GPU. There is no fallback: a timing or a check
  that silently ran on the CPU would be reported as the card's."""
  backend = jax.default_backend()
  if backend != "gpu":
    raise RuntimeError(
        f"an NVIDIA GPU is required, but JAX's default backend is "
        f"{backend!r} (devices: {jax.devices()})")
  return jax.devices()


def enable_compile_cache() -> str:
  """Turn on JAX's persistent compilation cache and return its
  directory. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already
  uses it and nothing else is set; otherwise the cache goes to
  :data:`REPO_CACHE_DIR`. Call before the first compilation: JAX fixes
  its cache the first time it compiles."""
  env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
  if env:
    return env
  jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
  return str(REPO_CACHE_DIR)
