"""Global configuration: dtypes, device policy and the compile cache.

The reference framework runs FEniCS/PETSc in float64 end-to-end.  Here:

* **Validation / CI** (CPU backend): enable x64, run everything in float64 so
  solutions match the reference's accuracy contract (nonlinear residual
  <= 1e-10, the reference's source/ns_solver_base.py:986-988).
* **Production** (GPU backend): float32 storage by default; with x64
  enabled the GPU keeps float64 on the device (it has hardware f64).

``default_dtype()`` is float64 exactly when x64 is enabled.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

#: fixed in-checkout compile-cache directory (gitignored); the path is part
#: of the cache key, so it must not move between runs
COMPILE_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def x64_enabled() -> bool:
    return bool(jax.config.read("jax_enable_x64"))


def default_dtype():
    """Device storage dtype: float64 iff x64 is enabled."""
    return jnp.float64 if x64_enabled() else jnp.float32


def default_int_dtype():
    return jnp.int32


def np_dtype():
    return np.float64 if x64_enabled() else np.float32


def default_tol() -> float:
    """Default nonlinear residual tolerance matched to the active precision.

    The reference asserts ||F||_2 <= 1e-10 (float64).  In float32 that is
    unreachable; 5e-5 tracks the same "converged to roundoff" contract.
    """
    return 1.0e-10 if x64_enabled() else 5.0e-5


def on_accelerator() -> bool:
    """True when the default JAX backend is not the CPU."""
    return jax.default_backend() != "cpu"


def enable_x64() -> None:
    """Opt into float64 (call before any tracing)."""
    jax.config.update("jax_enable_x64", True)


def use_compile_cache() -> str:
    """Give JAX a persistent compilation cache; returns its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is left for JAX to read and
    nothing is changed.  Otherwise the cache goes to the fixed
    :data:`COMPILE_CACHE_DIR` inside the checkout.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(COMPILE_CACHE_DIR))
    return str(COMPILE_CACHE_DIR)


_matmul_precision_set = False


def ensure_accurate_matmuls() -> None:
    """Force true-f32 matmul accumulation on accelerators.

    A float32 matmul on the GPU may run in TF32 (about three decimal
    digits per contraction), which would floor every Krylov solve on the
    assembly sweeps near 1e-3 relative residual.  Called by the operator
    constructors.
    """
    global _matmul_precision_set
    if _matmul_precision_set or not on_accelerator():
        return
    jax.config.update("jax_default_matmul_precision", "highest")
    _matmul_precision_set = True
