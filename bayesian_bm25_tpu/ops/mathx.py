"""Math primitives: dtype policy, stable sigmoid/logit, probability clamps.

Reference semantics: bayesian_bm25/probability.py:20-48 (epsilon clamp,
split-form sigmoid, logit). The reference is float64-only; this module is
dtype-neutral so the same kernels run in f64 for CPU parity tests and f32
on the GPU. The clamp epsilon is dtype-aware: 1e-10 is sub-resolution next to
1.0 in float32 (1 - 1e-10 rounds to 1.0), so f32 uses 1e-6.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Reference constants (bayesian_bm25/probability.py:20-21).
EPSILON_F64 = 1e-10
EPSILON_F32 = 1e-6
ALPHA_MIN = 0.01


def float_dtype() -> jnp.dtype:
    """Default floating dtype: float64 when x64 is enabled, else float32."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def as_float(x) -> jnp.ndarray:
    """Convert to the default floating dtype (keeps f64 inputs under x64)."""
    return jnp.asarray(x, dtype=float_dtype())


def epsilon(dtype) -> float:
    """Probability-clamp epsilon for a dtype."""
    if jnp.dtype(dtype) == jnp.float64:
        return EPSILON_F64
    return EPSILON_F32


def clamp_probability(p: jnp.ndarray) -> jnp.ndarray:
    """Clamp probability to [eps, 1 - eps] (reference probability.py:24-26)."""
    p = as_float(p)
    eps = epsilon(p.dtype)
    return jnp.clip(p, eps, 1.0 - eps)


def sigmoid(x) -> jnp.ndarray:
    """Numerically stable sigmoid (reference probability.py:29-41).

    ``jax.nn.sigmoid`` already uses a stable formulation on both branches.
    """
    return jax.nn.sigmoid(as_float(x))


def logit(p) -> jnp.ndarray:
    """Inverse sigmoid log(p / (1-p)) with epsilon clamp (probability.py:44-48)."""
    p = clamp_probability(p)
    return jnp.log(p) - jnp.log1p(-p)


def stable_softmax(z: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Shift-by-max softmax along ``axis`` (reference fusion.py:631-636, :1137-1143)."""
    z = as_float(z)
    z = z - jnp.max(z, axis=axis, keepdims=True)
    e = jnp.exp(z)
    return e / jnp.sum(e, axis=axis, keepdims=True)


def min_max_normalize(x: jnp.ndarray, axis=None) -> jnp.ndarray:
    """Min-max normalize to [0, 1]; zero-variance maps to zeros.

    Reference fusion.py:336-343. With ``axis`` given, normalizes each slice
    along that axis independently (used for per-signal logit normalization,
    fusion.py:730-746).
    """
    x = as_float(x)
    lo = jnp.min(x, axis=axis, keepdims=axis is not None)
    hi = jnp.max(x, axis=axis, keepdims=axis is not None)
    span = hi - lo
    safe = jnp.where(span < 1e-12, 1.0, span)
    out = (x - lo) / safe
    return jnp.where(span < 1e-12, jnp.zeros_like(out), out)


def segment_min_max_normalize(
    x: jnp.ndarray, segment_ids: jnp.ndarray, num_segments: int
) -> jnp.ndarray:
    """Per-segment min-max normalization along axis 0 (per-query groups).

    Vectorized replacement for the reference's per-query-id Python loop
    (fusion.py:879-887): one segment_min/segment_max pass instead of a loop
    over unique ids, so it stays O(n) and jit-compatible.
    """
    x = as_float(x)
    lo = jax.ops.segment_min(x, segment_ids, num_segments=num_segments)
    hi = jax.ops.segment_max(x, segment_ids, num_segments=num_segments)
    lo_g = lo[segment_ids]
    hi_g = hi[segment_ids]
    span = hi_g - lo_g
    safe = jnp.where(span < 1e-12, 1.0, span)
    out = (x - lo_g) / safe
    return jnp.where(span < 1e-12, jnp.zeros_like(out), out)
