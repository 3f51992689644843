"""Device placement policy: hot path on the accelerator, fit-time math on
the host CPU.

Batched scoring/retrieval kernels run on the accelerator. Small fit-time
work — per-query KDE/GMM calibration, GD fit loops, online updates — has
data-dependent shapes, and each new shape triggers a fresh accelerator
compilation that can dwarf the compute. Those call sites wrap themselves
in ``host_context()``: when a CPU device coexists with the accelerator
the computation compiles and runs on the host; on a CPU-only backend it
is a no-op. Whether this still pays on the GPU is not yet measured.
"""

from __future__ import annotations

import contextlib
from functools import lru_cache

import jax


@lru_cache(maxsize=1)
def host_cpu_device():
    try:
        return jax.devices("cpu")[0]
    except RuntimeError:
        return None


def host_context():
    """Context manager placing jax computations on the host CPU device."""
    dev = host_cpu_device()
    if dev is None or jax.default_backend() == "cpu":
        return contextlib.nullcontext()
    return jax.default_device(dev)


def on_host(fn):
    """Decorator: run ``fn``'s jax work on the host CPU device."""
    from functools import wraps

    @wraps(fn)
    def wrapper(*args, **kwargs):
        with host_context():
            return fn(*args, **kwargs)

    return wrapper
