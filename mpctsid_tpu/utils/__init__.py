"""Shared utilities: matmul precision policy and the compile cache.

On GPUs with TF32 tensor cores (Ampere and later, including the H100), XLA may
run an f32 `dot_general` at DEFAULT precision in TF32, which keeps a 10-bit
mantissa (about 3 decimal digits).  For this engine that is not a tuning knob
but a correctness cliff: the QP core's inverse and ADMM fixed point, the df32
polish residual and the leg-odometry Jacobian products all assume f32
products, and the contract (BASELINE.json:5, <1e-4 control error vs the CPU
oracle) cannot hold at 1e-3 relative error per product.

`f32_matmuls` pins matmul precision to full f32 (HIGHEST) for everything
traced inside the wrapped function.  It decorates the library functions that
trace the engine's dots (admm_solve, build_mpc_qp, build_wbc_qp, solve_wbc,
init_controller, cascade_period, cascade_rollout) and HostController's
programs, so a caller that jits or vmaps them needs nothing more.  Wrap only
a program that traces dots of its own outside those functions.
tests/test_precision_policy.py checks the lowered entry points for it.
"""

from __future__ import annotations

import functools
import os
import pathlib
import subprocess
import sys

import jax

__all__ = ["f32_matmuls", "configure_compile_cache", "CHECKOUT_CACHE_DIR",
           "device_info", "require_gpu", "card_label"]

# <checkout>/.jax_cache: a fixed path inside the checkout (listed in
# .gitignore), so the cache key's path component is stable between runs.
CHECKOUT_CACHE_DIR = str(pathlib.Path(__file__).resolve().parents[2]
                         / ".jax_cache")


def f32_matmuls(fn):
    """Trace `fn` with full-f32 matmul precision.

    Wrapping a jitted function also wraps its `.lower`, so ahead-of-time
    lowering (memory analysis, tests) sees the same precision as a call."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)

    if hasattr(fn, "lower"):
        def lower(*args, **kwargs):
            with jax.default_matmul_precision("float32"):
                return fn.lower(*args, **kwargs)
        wrapped.lower = lower
    return wrapped


def configure_compile_cache() -> str:
    """Enable JAX's persistent compilation cache; returns its directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already uses that directory and
    nothing is changed.  Otherwise the cache goes to CHECKOUT_CACHE_DIR."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR


def device_info() -> dict:
    """The default device as JAX reports it: platform, kind and count."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu(program: str, n_gpus: int = 1):
    """Exit non-zero unless JAX's default backend is a GPU with at least
    n_gpus devices.  Nothing falls back to another device."""
    devs = jax.devices()
    if jax.default_backend() != "gpu" or any(d.platform != "gpu"
                                              for d in devs):
        sys.exit(f"{program} needs a GPU; JAX's default backend is "
                 f"{jax.default_backend()} with {devs}")
    if len(devs) < n_gpus:
        sys.exit(f"{program} needs {n_gpus} GPUs, JAX sees {len(devs)}")


def card_label() -> list[str]:
    """The cards' `nvidia-smi --query-gpu=name,power.limit` lines, as it
    prints them, one per card.  Raises if nvidia-smi is missing or fails."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()
