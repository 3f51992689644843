"""Bayesian probability transform kernels (pure, jittable).

Implements the sigmoid-likelihood x composite-prior x posterior pipeline of
the reference ``BayesianProbabilityTransform`` (bayesian_bm25/probability.py:
51-473) as pure functions over jnp arrays, so the whole pipeline fuses into
the BM25 scoring kernel on the device. Stateful wrapper: models/probability.py.

Numeric contract (reference probability.py / SURVEY §2.4):
  likelihood      L = sigma(alpha * (s - beta))                   (:106-108)
  tf prior        P_tf = 0.2 + 0.7 * min(1, tf/10)                (:110-115)
  norm prior      P_n  = 0.3 + 0.6 * (1 - min(1, |r-0.5|*2))      (:117-129)
  composite prior clip(0.7*P_tf + 0.3*P_n, 0.1, 0.9)              (:131-140)
  posterior       two-step odds update with optional base rate    (:142-169)
  WAND UB         posterior(sigma(alpha*(UB-beta)), p_max=0.9)    (:205-236)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from bayesian_bm25_tpu.ops import mathx
from bayesian_bm25_tpu.ops.mathx import as_float, clamp_probability, sigmoid


class TransformParams(NamedTuple):
    """Learnable transform parameters as a pytree (alpha, beta are scalars)."""

    alpha: jnp.ndarray
    beta: jnp.ndarray


def likelihood(score, alpha, beta) -> jnp.ndarray:
    """Sigmoid likelihood sigma(alpha * (score - beta))."""
    return sigmoid(as_float(alpha) * (as_float(score) - as_float(beta)))


def tf_prior(tf) -> jnp.ndarray:
    """Term-frequency prior: 0.2 + 0.7 * min(1, tf / 10)."""
    tf = as_float(tf)
    return 0.2 + 0.7 * jnp.minimum(1.0, tf / 10.0)


def norm_prior(doc_len_ratio) -> jnp.ndarray:
    """Doc-length prior: peaks at 0.9 when doc_len/avgdl == 0.5, floor 0.3."""
    r = as_float(doc_len_ratio)
    return 0.3 + 0.6 * (1.0 - jnp.minimum(1.0, jnp.abs(r - 0.5) * 2.0))


def composite_prior(tf, doc_len_ratio) -> jnp.ndarray:
    """clip(0.7 * P_tf + 0.3 * P_norm, 0.1, 0.9)."""
    return jnp.clip(0.7 * tf_prior(tf) + 0.3 * norm_prior(doc_len_ratio), 0.1, 0.9)


def posterior(likelihood_val, prior, base_rate=None,
              likelihood_complement=None) -> jnp.ndarray:
    """Two-step Bayes odds update, equivalent to
    sigma(logit L + logit prior [+ logit base_rate]).

    Each step carries the complement 1 - q as its own quotient instead of
    subtracting q from 1, so f32 keeps its relative precision as q nears
    1; ``likelihood_complement`` (1 - L, e.g. sigma(-x)) does the same for
    the likelihood. Equal to the plain odds update in exact arithmetic,
    clamps included."""
    l_val = as_float(likelihood_val)
    l_c = (1.0 - l_val if likelihood_complement is None
           else as_float(likelihood_complement))
    p = as_float(prior)
    num, num_c = l_val * p, l_c * (1.0 - p)
    den = num + num_c
    out, out_c = clamp_probability(num / den), clamp_probability(num_c / den)
    if base_rate is not None:
        br = as_float(base_rate)
        num, num_c = out * br, out_c * (1.0 - br)
        out = clamp_probability(num / (num + num_c))
    return out


def score_to_probability(
    score,
    tf,
    doc_len_ratio,
    alpha,
    beta,
    base_rate=None,
    *,
    prior_free: bool = False,
    prior=None,
) -> jnp.ndarray:
    """Full score -> calibrated probability pipeline (probability.py:171-203).

    ``prior_free`` uses prior=0.5 (posterior == likelihood before base rate).
    ``prior`` overrides the composite prior with precomputed values (the
    custom ``prior_fn`` path is evaluated by the caller, host-side).
    """
    x = as_float(alpha) * (as_float(score) - as_float(beta))
    l_val, l_c = sigmoid(x), sigmoid(-x)
    if prior_free:
        p = jnp.asarray(0.5, dtype=l_val.dtype)
    elif prior is not None:
        p = clamp_probability(prior)
    else:
        p = composite_prior(tf, doc_len_ratio)
    return posterior(l_val, p, base_rate=base_rate, likelihood_complement=l_c)


def wand_upper_bound(bm25_upper_bound, alpha, beta, base_rate=None, p_max=0.9):
    """Safe Bayesian probability upper bound for WAND pruning
    (probability.py:205-236): posterior of the max likelihood at prior p_max."""
    l_max = likelihood(bm25_upper_bound, alpha, beta)
    return posterior(l_max, p_max, base_rate=base_rate)


def wand_score_threshold(threshold: float, alpha: float, beta: float,
                         base_rate: float | None = None,
                         p_max: float = 0.9) -> float:
    """Inverse of ``wand_upper_bound``: the smallest BM25 score whose
    certified probability upper bound reaches ``threshold`` (host-side
    scalar math, float64).

    Every pipeline stage is monotone increasing in the score — sigmoid
    likelihood, the odds update at any prior <= p_max (composite_prior
    clips at 0.9), and the base-rate odds shift — so a doc scoring below
    the returned value cannot have calibrated probability >= threshold.
    That turns a probability threshold into a score prefilter
    (probability.py:205-236's bound, run backwards); survivors get exact
    probabilities, so pruning is output-invariant. A small downward
    margin absorbs f32-vs-f64 rounding between this inverse and the
    device kernel (conservative: it can only admit extra candidates).
    Returns -inf when the threshold prunes nothing (t <= 0, or a
    non-positive alpha, where the bound is not invertible).
    """
    import numpy as np

    t = float(threshold)
    a = float(alpha)
    if t <= 0.0 or a <= 0.0:
        return float("-inf")
    if t >= 1.0:
        return float("inf")
    odds = t / (1.0 - t)
    if base_rate is not None:
        br = min(max(float(base_rate), 1e-12), 1.0 - 1e-12)
        odds *= (1.0 - br) / br
    odds_l = odds * (1.0 - p_max) / p_max
    l_min = odds_l / (1.0 + odds_l)
    s_min = float(beta) + float(np.log(l_min) - np.log1p(-l_min)) / a
    if not np.isfinite(s_min):
        return float("-inf") if s_min < 0 else float("inf")
    return s_min - 1e-4 * max(1.0, abs(s_min))


# ---------------------------------------------------------------------------
# Batch fitting (Algorithm 8.3.1): GD with tolerance early-exit as while_loop
# ---------------------------------------------------------------------------


def _bce_grads(alpha, beta, scores, labels, priors, weights, prior_aware: bool):
    """Mean BCE gradients wrt (alpha, beta), optionally through the posterior.

    ``prior_aware`` selects the C2 chain-rule path (probability.py:306-322);
    otherwise the C1/C3 likelihood path (:323-328). ``weights`` are per-sample
    gradient weights (temporal decay); pass ones for the plain transform.
    """
    L = clamp_probability(sigmoid(alpha * (scores - beta)))
    if prior_aware:
        p = priors
        denom = L * p + (1.0 - L) * (1.0 - p)
        predicted = clamp_probability(L * p / denom)
        dP_dL = p * (1.0 - p) / (denom * denom)
        dL_da = L * (1.0 - L) * (scores - beta)
        dL_db = -L * (1.0 - L) * alpha
        err = predicted - labels
        g_a = jnp.mean(weights * err * dP_dL * dL_da)
        g_b = jnp.mean(weights * err * dP_dL * dL_db)
    else:
        err = L - labels
        g_a = jnp.mean(weights * err * (scores - beta))
        g_b = jnp.mean(weights * err * (-alpha))
    return g_a, g_b


def fit_transform(
    alpha0,
    beta0,
    scores,
    labels,
    *,
    prior_aware: bool,
    priors=None,
    sample_weights=None,
    learning_rate: float = 0.01,
    max_iterations: int = 1000,
    tolerance: float = 1e-6,
):
    """Jitted batch GD on BCE with tolerance-based early exit.

    The reference's ``for ... break`` loop (probability.py:303-339) becomes a
    ``lax.while_loop`` carrying (alpha, beta, done, it); the final update is
    still applied on the converging step, matching reference semantics.
    """
    scores = as_float(scores)
    labels = as_float(labels)
    dt = scores.dtype
    weights = (
        jnp.ones_like(scores) if sample_weights is None else as_float(sample_weights)
    )
    priors_arr = (
        jnp.zeros_like(scores) if priors is None else as_float(priors)
    )
    lr = jnp.asarray(learning_rate, dt)
    tol = jnp.asarray(tolerance, dt)

    def cond(state):
        _, _, done, it = state
        return jnp.logical_and(~done, it < max_iterations)

    def body(state):
        a, b, _, it = state
        g_a, g_b = _bce_grads(a, b, scores, labels, priors_arr, weights, prior_aware)
        na = a - lr * g_a
        nb = b - lr * g_b
        done = jnp.logical_and(jnp.abs(na - a) < tol, jnp.abs(nb - b) < tol)
        return na, nb, done, it + 1

    a0 = jnp.asarray(alpha0, dt)
    b0 = jnp.asarray(beta0, dt)
    alpha, beta, _, n_iter = jax.lax.while_loop(
        cond, body, (a0, b0, jnp.asarray(False), jnp.asarray(0))
    )
    return alpha, beta, n_iter


_fit_transform_jit = jax.jit(
    fit_transform,
    static_argnames=("prior_aware", "max_iterations"),
)


def fit_transform_jit(*args, **kwargs):
    """Jit entry point (static: prior_aware, max_iterations)."""
    return _fit_transform_jit(*args, **kwargs)


# ---------------------------------------------------------------------------
# Online update (probability.py:350-473): EMA + bias correction + clip +
# lr decay + alpha floor + Polyak averaging, as a pure step over state pytree
# ---------------------------------------------------------------------------


class OnlineTransformState(NamedTuple):
    alpha: jnp.ndarray
    beta: jnp.ndarray
    grad_alpha_ema: jnp.ndarray
    grad_beta_ema: jnp.ndarray
    alpha_avg: jnp.ndarray
    beta_avg: jnp.ndarray
    n_updates: jnp.ndarray  # int32


def init_online_state(alpha, beta) -> OnlineTransformState:
    a = as_float(alpha)
    b = as_float(beta)
    z = jnp.zeros_like(a)
    return OnlineTransformState(a, b, z, z, a, b, jnp.asarray(0, jnp.int32))


def online_update_step(
    state: OnlineTransformState,
    scores,
    labels,
    *,
    prior_aware: bool,
    priors=None,
    learning_rate: float = 0.01,
    momentum: float = 0.9,
    decay_tau: float = 1000.0,
    max_grad_norm: float = 1.0,
    avg_decay: float = 0.995,
) -> OnlineTransformState:
    """One online SGD update (single observation or mini-batch)."""
    scores = jnp.atleast_1d(as_float(scores))
    labels = jnp.atleast_1d(as_float(labels))
    dt = scores.dtype
    priors_arr = jnp.zeros_like(scores) if priors is None else as_float(priors)
    ones = jnp.ones_like(scores)

    g_a, g_b = _bce_grads(
        state.alpha, state.beta, scores, labels, priors_arr, ones, prior_aware
    )

    mom = jnp.asarray(momentum, dt)
    ema_a = mom * state.grad_alpha_ema + (1.0 - mom) * g_a
    ema_b = mom * state.grad_beta_ema + (1.0 - mom) * g_b

    t = state.n_updates + 1
    correction = 1.0 - mom ** t.astype(dt)
    c_a = ema_a / correction
    c_b = ema_b / correction

    norm = jnp.sqrt(c_a * c_a + c_b * c_b)
    scale = jnp.where(norm > max_grad_norm, max_grad_norm / norm, 1.0)
    c_a = c_a * scale
    c_b = c_b * scale

    lr = jnp.asarray(learning_rate, dt) / (1.0 + t.astype(dt) / decay_tau)
    alpha = jnp.maximum(state.alpha - lr * c_a, mathx.ALPHA_MIN)
    beta = state.beta - lr * c_b

    ad = jnp.asarray(avg_decay, dt)
    alpha_avg = ad * state.alpha_avg + (1.0 - ad) * alpha
    beta_avg = ad * state.beta_avg + (1.0 - ad) * beta

    return OnlineTransformState(alpha, beta, ema_a, ema_b, alpha_avg, beta_avg, t)


online_update_step_jit = jax.jit(
    online_update_step, static_argnames=("prior_aware",)
)
