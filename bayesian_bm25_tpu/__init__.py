"""Bayesian BM25 — calibrated retrieval probabilities on JAX/XLA.

A from-scratch framework with the capabilities of the reference
``bayesian_bm25`` library: sigmoid-likelihood + composite-prior posterior
transforms for BM25 scores, log-odds fusion algebra with learnable /
attention weighting, KDE/GMM likelihood-ratio calibration of dense vector
distances, an owned BM25 engine with device-resident indexes and XLA
scoring kernels, WAND/BMW probability upper bounds, calibration metrics,
and a full-pipeline fusion debugger.

Architecture:
  * ``ops``      — pure functional jnp kernels (jit-compatible, dtype-neutral)
  * ``engine``   — owned BM25 engine: host-side tokenizer/vocab/index build,
                   device-resident doc-major index, XLA scoring kernels
  * ``models``   — thin stateful wrappers reproducing the reference API
  * ``parallel`` — jax.sharding mesh layer: document-axis sharding, collective
                   stats, distributed top-k merge
  * ``utils``    — calibration metrics, fusion debugger, serialization

Public API mirrors the reference package ``bayesian_bm25/__init__.py:11-55``.
"""

import os as _os

import jax as _jax


def compile_cache_dir() -> str:
    """Where the persistent compilation cache lives:
    ``JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.cache/jax``.

    The path is part of the cache's key, so it is fixed: never derived
    from a temporary name, a process id or the time."""
    env = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    return _os.path.join(root, ".cache", "jax")


# Persistent compilation cache: every retrieval shape bucket compiles
# once per machine instead of once per process. JAX itself reads
# JAX_COMPILATION_CACHE_DIR when it is set; otherwise the cache goes
# inside the checkout. A directory configured before import is kept.
if _jax.config.jax_compilation_cache_dir is None:
    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from bayesian_bm25_tpu.models.probability import (
    BayesianProbabilityTransform,
    TemporalBayesianTransform,
)
from bayesian_bm25_tpu.models.fusion_weights import (
    AttentionLogOddsWeights,
    LearnableLogOddsWeights,
    MultiHeadAttentionLogOddsWeights,
)
from bayesian_bm25_tpu.api_fusion import (
    balanced_log_odds_fusion,
    cosine_to_probability,
    log_odds_conjunction,
    prob_and,
    prob_not,
    prob_or,
)
from bayesian_bm25_tpu.utils.metrics import (
    CalibrationReport,
    brier_score,
    calibration_report,
    expected_calibration_error,
    log_loss,
    reliability_diagram,
)

__version__ = "0.1.0"

__all__ = [
    "__version__",
    "AttentionLogOddsWeights",
    "BayesianProbabilityTransform",
    "BayesianBM25Scorer",
    "BlockMaxIndex",
    "CalibrationReport",
    "FusionDebugger",
    "IsotonicCalibrator",
    "LearnableLogOddsWeights",
    "MultiFieldScorer",
    "MultiHeadAttentionLogOddsWeights",
    "PlattCalibrator",
    "RetrievalResult",
    "ShardedBayesianBM25Scorer",
    "TemporalBayesianTransform",
    "VectorProbabilityTransform",
    "balanced_log_odds_fusion",
    "brier_score",
    "calibration_report",
    "cosine_to_probability",
    "expected_calibration_error",
    "ivf_density_prior",
    "knn_density_prior",
    "log_loss",
    "log_odds_conjunction",
    "prob_and",
    "prob_not",
    "prob_or",
    "reliability_diagram",
]


def __getattr__(name: str):
    # Lazy imports for heavier modules (engine construction, debug tracing),
    # mirroring the reference's lazy import surface.
    if name in ("BayesianBM25Scorer", "RetrievalResult"):
        from bayesian_bm25_tpu.models import scorer as _scorer

        return getattr(_scorer, name)
    if name == "ShardedBayesianBM25Scorer":
        from bayesian_bm25_tpu.parallel.sharded_scorer import (
            ShardedBayesianBM25Scorer,
        )

        return ShardedBayesianBM25Scorer
    if name == "BlockMaxIndex":
        from bayesian_bm25_tpu.engine.block_max import BlockMaxIndex

        return BlockMaxIndex
    if name == "MultiFieldScorer":
        from bayesian_bm25_tpu.models.multi_field import MultiFieldScorer

        return MultiFieldScorer
    if name == "FusionDebugger":
        from bayesian_bm25_tpu.utils.debug import FusionDebugger

        return FusionDebugger
    if name in ("PlattCalibrator", "IsotonicCalibrator"):
        from bayesian_bm25_tpu.models import calibration as _cal

        return getattr(_cal, name)
    if name in (
        "VectorProbabilityTransform",
        "ivf_density_prior",
        "knn_density_prior",
    ):
        from bayesian_bm25_tpu.models import vector_probability as _vp

        return getattr(_vp, name)
    raise AttributeError(f"module 'bayesian_bm25_tpu' has no attribute {name!r}")
