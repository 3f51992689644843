"""compat.install(): reference user code runs unchanged against the
package's implementation (virtual ``bayesian_bm25`` package in sys.modules,
mapping /root/reference/bayesian_bm25/__init__.py:11-55)."""

import sys

import numpy as np
import pytest

from bayesian_bm25_tpu import compat


@pytest.fixture()
def installed():
    compat.install(force=True)
    yield
    compat.uninstall()


class TestInstall:
    def test_top_level_surface(self, installed):
        import bayesian_bm25 as bb

        import bayesian_bm25_tpu as ours
        assert bb.__bb25_tpu_compat__
        for n in ["BayesianBM25Scorer", "BayesianProbabilityTransform",
                  "MultiFieldScorer", "PlattCalibrator",
                  "VectorProbabilityTransform", "prob_and",
                  "log_odds_conjunction", "expected_calibration_error"]:
            assert getattr(bb, n) is getattr(ours, n)

    def test_submodule_imports(self, installed):
        from bayesian_bm25.calibration import IsotonicCalibrator  # noqa
        from bayesian_bm25.fusion import (  # noqa
            AttentionLogOddsWeights, prob_or)
        from bayesian_bm25.probability import logit, sigmoid
        from bayesian_bm25.scorer import (  # noqa: F401
            BayesianBM25Scorer, BlockMaxIndex, RetrievalResult)

        assert sigmoid(0.0) == pytest.approx(0.5)
        assert logit(0.5) == pytest.approx(0.0)
        s = BayesianBM25Scorer()
        s.index([["a", "b"], ["b", "c"], ["c", "d"]],
                show_progress=False)
        ids, probs = s.retrieve([["b"]], k=2)
        assert np.asarray(ids).shape == (1, 2)

    def test_reference_style_snippet(self, installed):
        """A verbatim reference README-style flow."""
        import bayesian_bm25 as bb

        rng = np.random.default_rng(0)
        scores = rng.gamma(2.0, 2.0, 500)
        labels = (rng.uniform(size=500)
                  < 1 / (1 + np.exp(-1.0 * (scores - 4)))).astype(float)
        t = bb.BayesianProbabilityTransform(alpha=0.5, beta=1.0,
                                            base_rate=0.05)
        t.fit(scores, labels, learning_rate=0.05, max_iterations=200)
        p = t.score_to_probability(
            scores, np.ones_like(scores), np.ones_like(scores))
        assert ((np.asarray(p) > 0) & (np.asarray(p) < 1)).all()

    def test_uninstall(self):
        compat.install(force=True)
        assert "bayesian_bm25" in sys.modules
        compat.uninstall()
        assert "bayesian_bm25" not in sys.modules

    def test_idempotent(self, installed):
        compat.install()  # virtual module present -> no error
        import bayesian_bm25  # noqa: F401
