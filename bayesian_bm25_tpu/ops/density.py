"""Density estimation kernels: Gaussian pdf, weighted KDE, GMM-EM, gap
detection.

Pure jnp implementations of the reference's vector-calibration math
(bayesian_bm25/vector_probability.py:36-115, :191-431). The KDE evaluates
one dense (n_eval, n_sample) kernel matrix — ideal accelerator work — and the GMM
EM runs as a lax.while_loop with the background component fixed
(Remark 5.3.2 semantics).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from bayesian_bm25_tpu.ops.mathx import as_float, epsilon, sigmoid

_SQRT_2PI = math.sqrt(2.0 * math.pi)


def gaussian_pdf(x, mu, sigma) -> jnp.ndarray:
    """Normal density without scipy."""
    x = as_float(x)
    z = (x - mu) / sigma
    return jnp.exp(-0.5 * z * z) / (sigma * _SQRT_2PI)


def silverman_bandwidth(distances, weights=None) -> jnp.ndarray:
    """Weighted Silverman rule: h = 1.06 * sigma_w * K_eff^(-1/5), with
    K_eff = (sum w)^2 / sum(w^2) (vector_probability.py:52-83)."""
    d = as_float(distances)
    eps = epsilon(d.dtype)
    w = jnp.ones_like(d) if weights is None else as_float(weights)
    w_sum = jnp.sum(w)
    w_sq = jnp.sum(w * w)
    k_eff = (w_sum * w_sum) / jnp.maximum(w_sq, eps)
    mean = jnp.sum(w * d) / jnp.maximum(w_sum, eps)
    var = jnp.sum(w * (d - mean) ** 2) / jnp.maximum(w_sum, eps)
    sigma_w = jnp.sqrt(jnp.maximum(var, 0.0))
    h = 1.06 * sigma_w * k_eff ** (-0.2)
    h = jnp.where(sigma_w < eps, eps, jnp.maximum(h, eps))
    return jnp.where(jnp.logical_or(w_sum < eps, w_sq < eps), eps, h)


def kernel_density(eval_points, sample_points, weights, bandwidth) -> jnp.ndarray:
    """Weighted Gaussian KDE via one (n_eval, n_sample) kernel matrix."""
    e = as_float(eval_points)
    s = as_float(sample_points)
    w = as_float(weights)
    eps = epsilon(e.dtype)
    diff = (e[:, None] - s[None, :]) / bandwidth
    kern = jnp.exp(-0.5 * diff * diff) / (bandwidth * _SQRT_2PI)
    w_sum = jnp.sum(w)
    dens = kern @ w / jnp.maximum(w_sum, eps)
    dens = jnp.maximum(dens, eps)
    return jnp.where(w_sum < eps, jnp.full_like(dens, eps), dens)


class GMMState(NamedTuple):
    mu_R: jnp.ndarray
    sigma_R: jnp.ndarray
    pi_R: jnp.ndarray
    prev_ll: jnp.ndarray
    done: jnp.ndarray
    it: jnp.ndarray


def gmm_fixed_background(
    distances, mu_G, sigma_G, mu_R0, sigma_R0, pi_R0,
    *, max_iter: int = 100, tol: float = 1e-6, mask=None,
):
    """Two-component GMM-EM with the background (G) component frozen;
    only (mu_R, sigma_R, pi_R) update (vector_probability.py:396-428).

    ``mask`` (0/1 per sample) supports shape-bucketed padding: masked-out
    points contribute nothing to the E/M sums and the sample count, so a
    padded call matches the unpadded one exactly.

    Returns the fitted (mu_R, sigma_R, pi_R).
    """
    d = as_float(distances)
    eps = epsilon(d.dtype)
    m = jnp.ones_like(d) if mask is None else as_float(mask)
    n = jnp.sum(m)
    f_G_fixed = gaussian_pdf(d, mu_G, sigma_G)

    def cond(s: GMMState):
        return jnp.logical_and(~s.done, s.it < max_iter)

    def body(s: GMMState):
        f_R = s.pi_R * gaussian_pdf(d, s.mu_R, s.sigma_R)
        f_G = (1.0 - s.pi_R) * f_G_fixed
        total = jnp.maximum(f_R + f_G, eps)
        gamma = (f_R / total) * m
        ll = jnp.sum(jnp.log(total) * m)
        converged = jnp.abs(ll - s.prev_ll) < tol

        gsum = jnp.sum(gamma)
        degenerate = gsum < eps
        safe_gsum = jnp.maximum(gsum, eps)
        mu_new = jnp.sum(gamma * d) / safe_gsum
        sig_new = jnp.sqrt(jnp.sum(gamma * (d - mu_new) ** 2) / safe_gsum)
        sig_new = jnp.where(sig_new < eps, sigma_G * 0.1, sig_new)
        pi_new = jnp.clip(gsum / n, 0.01, 0.99)

        # On convergence or degeneracy, keep previous params (reference
        # breaks before the M-step).
        keep = jnp.logical_or(converged, degenerate)
        return GMMState(
            mu_R=jnp.where(keep, s.mu_R, mu_new),
            sigma_R=jnp.where(keep, s.sigma_R, sig_new),
            pi_R=jnp.where(keep, s.pi_R, pi_new),
            prev_ll=ll,
            done=keep,
            it=s.it + 1,
        )

    init = GMMState(
        as_float(mu_R0), as_float(sigma_R0), as_float(pi_R0),
        jnp.asarray(-jnp.inf, d.dtype), jnp.asarray(False), jnp.asarray(0),
    )
    final = jax.lax.while_loop(cond, body, init)
    return final.mu_R, final.sigma_R, final.pi_R


def detect_gap_index(distances, threshold_ratio: float = 0.15):
    """Semantic-cliff detection in sorted distances (Strategy 4.6.1).

    Returns (gap_index, found): index in sorted order of the first element
    AFTER the gap. Primary criterion: max gap / total span >= ratio;
    fallback: gap z-score > 2.0. Host callers convert (found=False) to None.
    """
    d = as_float(distances)
    eps = epsilon(d.dtype)
    n = d.shape[0]
    if n < 3:
        return jnp.asarray(0), jnp.asarray(False)
    sorted_d = jnp.sort(d)
    gaps = jnp.diff(sorted_d)
    span = sorted_d[-1] - sorted_d[0]

    ratios = gaps / jnp.maximum(span, eps)
    ratio_idx = jnp.argmax(ratios)
    primary = ratios[ratio_idx] >= threshold_ratio

    mean_gap = jnp.mean(gaps)
    std_gap = jnp.std(gaps)
    z = (gaps - mean_gap) / jnp.maximum(std_gap, eps)
    z_idx = jnp.argmax(z)
    fallback = jnp.logical_and(std_gap > eps, z[z_idx] > 2.0)

    found = jnp.logical_and(span >= eps, jnp.logical_or(primary, fallback))
    idx = jnp.where(primary, ratio_idx + 1, z_idx + 1)
    return idx, found


def gap_weights(distances):
    """Binary weights: 1.0 below the detected gap threshold, 0.0 above.
    Returns (weights, found)."""
    d = as_float(distances)
    idx, found = detect_gap_index(d)
    if d.shape[0] < 3:
        return jnp.ones_like(d), jnp.asarray(False)
    sorted_d = jnp.sort(d)
    threshold = sorted_d[idx]
    return jnp.where(d < threshold, 1.0, 0.0), found


def sharpen_weights(weights, temperature: float = 0.05) -> jnp.ndarray:
    """Softmax-temperature sharpening preserving total mass
    (vector_probability.py:253-280)."""
    w = as_float(weights)
    eps = epsilon(w.dtype)
    total = jnp.sum(w)
    sharp = jnp.exp((w - jnp.max(w)) / temperature)
    ssum = jnp.sum(sharp)
    return jnp.where(ssum > eps, sharp * (total / ssum), sharp)


def distance_density_weights(distances) -> jnp.ndarray:
    """Fallback weights sigma(median(d)/d - 1): closer -> heavier
    (vector_probability.py:282-294)."""
    d = as_float(distances)
    eps = epsilon(d.dtype)
    med = jnp.median(d)
    return sigmoid(med / jnp.maximum(d, eps) - 1.0)
