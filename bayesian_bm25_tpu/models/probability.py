"""Stateful BayesianProbabilityTransform / TemporalBayesianTransform.

API-parity wrappers over the pure kernels in ``ops.transform``
(reference: bayesian_bm25/probability.py:51-667). State is a handful of
Python floats — pickle/deepcopy friendly by construction — and every
compute path dispatches to a jitted kernel, so the same objects work on
CPU (f64 parity) and the GPU (f32).
"""

from __future__ import annotations

import numpy as np

from bayesian_bm25_tpu.ops.placement import on_host

from bayesian_bm25_tpu.ops import transform as T

_VALID_MODES = ("balanced", "prior_aware", "prior_free")


def _ret(x, *inputs):
    arr = np.asarray(x)
    if arr.ndim == 0 and all(np.ndim(i) == 0 for i in inputs):
        return float(arr)
    return arr


@on_host
def sigmoid(x):
    """Stable sigmoid (module-level parity with probability.py:29-41)."""
    from bayesian_bm25_tpu.ops.mathx import sigmoid as _s

    return _ret(_s(x), x)


@on_host
def logit(p):
    """Clamped logit (module-level parity with probability.py:44-48)."""
    from bayesian_bm25_tpu.ops.mathx import logit as _l

    return _ret(_l(p), p)


class BayesianProbabilityTransform:
    """Transforms raw BM25 scores into calibrated probabilities.

    Parameters mirror the reference (probability.py:51-95): ``alpha`` is the
    sigmoid steepness, ``beta`` the midpoint, ``base_rate`` an optional
    corpus-level relevance rate in (0, 1) applied via a two-step Bayes
    update, ``prior_fn`` an optional callable replacing the composite prior.
    """

    _VALID_MODES = _VALID_MODES

    def __init__(self, alpha=1.0, beta=0.0, base_rate=None, prior_fn=None):
        if base_rate is not None and not (0.0 < base_rate < 1.0):
            raise ValueError(f"base_rate must be in (0, 1), got {base_rate}")
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.base_rate = base_rate
        self._prior_fn = prior_fn
        self._training_mode = "balanced"
        self._n_updates = 0
        self._grad_alpha_ema = 0.0
        self._grad_beta_ema = 0.0
        self._alpha_avg = float(alpha)
        self._beta_avg = float(beta)

    # -- inference ---------------------------------------------------------

    @property
    def averaged_alpha(self) -> float:
        """Polyak-averaged alpha for stable inference after online updates."""
        return self._alpha_avg

    @property
    def averaged_beta(self) -> float:
        """Polyak-averaged beta for stable inference after online updates."""
        return self._beta_avg

    @on_host
    def likelihood(self, score):
        """sigma(alpha * (score - beta))."""
        return _ret(T.likelihood(score, self.alpha, self.beta), score)

    @staticmethod
    @on_host
    def tf_prior(tf):
        """0.2 + 0.7 * min(1, tf / 10)."""
        return _ret(T.tf_prior(tf), tf)

    @staticmethod
    @on_host
    def norm_prior(doc_len_ratio):
        """0.3 + 0.6 * (1 - min(1, |r - 0.5| * 2))."""
        return _ret(T.norm_prior(doc_len_ratio), doc_len_ratio)

    @staticmethod
    @on_host
    def composite_prior(tf, doc_len_ratio):
        """clip(0.7 * P_tf + 0.3 * P_norm, 0.1, 0.9)."""
        return _ret(T.composite_prior(tf, doc_len_ratio), tf, doc_len_ratio)

    @staticmethod
    @on_host
    def posterior(likelihood_val, prior, base_rate=None):
        """Two-step Bayes odds update (probability.py:142-169)."""
        return _ret(
            T.posterior(likelihood_val, prior, base_rate),
            likelihood_val, prior,
        )

    @on_host
    def score_to_probability(self, score, tf, doc_len_ratio):
        """Full pipeline: score -> likelihood -> prior -> posterior."""
        prior = None
        if self._training_mode != "prior_free" and self._prior_fn is not None:
            prior = np.asarray(self._prior_fn(score, tf, doc_len_ratio))
        out = T.score_to_probability(
            score, tf, doc_len_ratio, self.alpha, self.beta, self.base_rate,
            prior_free=self._training_mode == "prior_free", prior=prior,
        )
        return _ret(out, score, tf, doc_len_ratio)

    @on_host
    def wand_upper_bound(self, bm25_upper_bound, p_max: float = 0.9):
        """Safe Bayesian probability upper bound for WAND pruning."""
        return _ret(
            T.wand_upper_bound(
                bm25_upper_bound, self.alpha, self.beta, self.base_rate, p_max
            ),
            bm25_upper_bound,
        )

    # -- learning ----------------------------------------------------------

    def _validate_mode(self, mode, tfs, doc_len_ratios):
        if mode not in self._VALID_MODES:
            raise ValueError(
                f"mode must be one of {self._VALID_MODES}, got {mode!r}"
            )
        if mode == "prior_aware" and (tfs is None or doc_len_ratios is None):
            raise ValueError(
                "tfs and doc_len_ratios are required when mode='prior_aware'"
            )

    @on_host
    def fit(
        self,
        scores,
        labels,
        *,
        learning_rate: float = 0.01,
        max_iterations: int = 1000,
        tolerance: float = 1e-6,
        mode: str = "balanced",
        tfs=None,
        doc_len_ratios=None,
        sample_weights=None,
    ) -> None:
        """Batch GD on BCE (Algorithm 8.3.1) as a jitted while_loop.

        Modes: "balanced" (C1, trains the likelihood), "prior_aware" (C2,
        trains the full posterior via chain rule), "prior_free" (C3, trains
        the likelihood and infers with prior=0.5). ``sample_weights`` is the
        temporal-weighting hook used by TemporalBayesianTransform.
        """
        self._validate_mode(mode, tfs, doc_len_ratios)
        priors = None
        if mode == "prior_aware":
            priors = np.asarray(T.composite_prior(tfs, doc_len_ratios))
        alpha, beta, _ = T.fit_transform_jit(
            self.alpha, self.beta,
            np.asarray(scores, dtype=np.float64),
            np.asarray(labels, dtype=np.float64),
            prior_aware=mode == "prior_aware",
            priors=priors,
            sample_weights=sample_weights,
            learning_rate=learning_rate,
            max_iterations=max_iterations,
            tolerance=tolerance,
        )
        self.alpha = float(alpha)
        self.beta = float(beta)
        self._training_mode = mode
        self._n_updates = 0
        self._grad_alpha_ema = 0.0
        self._grad_beta_ema = 0.0
        self._alpha_avg = self.alpha
        self._beta_avg = self.beta

    @on_host
    def update(
        self,
        score,
        label,
        *,
        learning_rate: float = 0.01,
        momentum: float = 0.9,
        decay_tau: float = 1000.0,
        max_grad_norm: float = 1.0,
        avg_decay: float = 0.995,
        mode: str | None = None,
        tf=None,
        doc_len_ratio=None,
    ) -> None:
        """Online SGD update: EMA smoothing + bias correction + L2 clip +
        lr decay + alpha floor + Polyak averaging (probability.py:350-473)."""
        effective_mode = mode if mode is not None else self._training_mode
        self._validate_mode(effective_mode, tf, doc_len_ratio)
        if mode is not None:
            self._training_mode = effective_mode

        priors = None
        if effective_mode == "prior_aware":
            priors = np.atleast_1d(np.asarray(T.composite_prior(tf, doc_len_ratio)))

        state = T.OnlineTransformState(
            alpha=np.float64(self.alpha),
            beta=np.float64(self.beta),
            grad_alpha_ema=np.float64(self._grad_alpha_ema),
            grad_beta_ema=np.float64(self._grad_beta_ema),
            alpha_avg=np.float64(self._alpha_avg),
            beta_avg=np.float64(self._beta_avg),
            n_updates=np.int32(self._n_updates),
        )
        new = T.online_update_step_jit(
            state,
            np.atleast_1d(np.asarray(score, dtype=np.float64)),
            np.atleast_1d(np.asarray(label, dtype=np.float64)),
            prior_aware=effective_mode == "prior_aware",
            priors=priors,
            learning_rate=learning_rate,
            momentum=momentum,
            decay_tau=decay_tau,
            max_grad_norm=max_grad_norm,
            avg_decay=avg_decay,
        )
        self.alpha = float(new.alpha)
        self.beta = float(new.beta)
        self._grad_alpha_ema = float(new.grad_alpha_ema)
        self._grad_beta_ema = float(new.grad_beta_ema)
        self._alpha_avg = float(new.alpha_avg)
        self._beta_avg = float(new.beta_avg)
        self._n_updates = int(new.n_updates)


class TemporalBayesianTransform(BayesianProbabilityTransform):
    """Transform with exponential time-decay sample weights
    (probability.py:476-667)."""

    def __init__(self, alpha=1.0, beta=0.0, base_rate=None,
                 decay_half_life: float = 1000.0):
        if decay_half_life <= 0.0:
            raise ValueError(
                f"decay_half_life must be positive, got {decay_half_life}"
            )
        super().__init__(alpha=alpha, beta=beta, base_rate=base_rate)
        self._decay_half_life = float(decay_half_life)
        self._decay_rate = float(np.log(2.0) / decay_half_life)
        self._timestamp = 0

    @property
    def decay_half_life(self) -> float:
        return self._decay_half_life

    @property
    def timestamp(self) -> int:
        return self._timestamp

    @on_host
    def fit(self, scores, labels, *, timestamps=None, **kwargs) -> None:
        """Batch fit with per-sample weights exp(-ln2/half_life*(max_ts-ts)),
        normalized to sum to n (probability.py:571-578)."""
        sample_weights = None
        if timestamps is not None:
            ts = np.asarray(timestamps, dtype=np.float64)
            w = np.exp(-self._decay_rate * (float(np.max(ts)) - ts))
            sample_weights = w * (len(ts) / float(np.sum(w)))
        super().fit(scores, labels, sample_weights=sample_weights, **kwargs)

    @on_host
    def update(self, score, label, *, avg_decay: float = 0.995, **kwargs) -> None:
        """Online update with timestamp-shrunk Polyak decay
        avg_decay*(1 - 1/(1+t)) (probability.py:652-655)."""
        self._timestamp += 1
        effective = avg_decay * (1.0 - 1.0 / (1.0 + self._timestamp))
        super().update(score, label, avg_decay=effective, **kwargs)
