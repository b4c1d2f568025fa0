"""Memoizer for kernel/function factories.

Reference: ``taichi_image/util.py:7`` (``cache = lru_cache(maxsize=None)``).
Here `jax.jit` already memoizes compiled executables per static
argument tuple; this cache is used for trace-time table construction
(weight tables, jitted closures specialized by dtype/pattern/flags).
"""

from functools import lru_cache

cache = lru_cache(maxsize=None)
