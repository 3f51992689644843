"""Rank-only fast tier (``coarse=True``): the int8 scoring matmul drops
its lo-residual pass. A recall-tolerant serving trade, NOT an exact
transform — these tests pin its contract:

* high top-k agreement with the exact int8 path (the ~0.8% score error
  reorders only near-ties);
* probabilities stay valid and within the coarse error class of exact;
* exact no-op under the hilo / f32 storage modes (no silent behavior
  change for exact-storage callers);
* composes with approx and doc_mask.

Ref intent: a serving extension with no reference analogue, opt-in
like ``approx``.
"""

import numpy as np
import pytest

from bayesian_bm25_tpu import BayesianBM25Scorer


def _corpus(seed=0, D=600, V=800, L=60):
    rng = np.random.default_rng(seed)
    return [[f"t{t}" for t in rng.zipf(1.3, size=L) % V] for _ in range(D)]


def _queries(seed=1, n=48, V=800):
    rng = np.random.default_rng(seed)
    qs = [[f"t{t}" for t in rng.zipf(1.3, size=6) % V] for _ in range(n)]
    return qs + [["t1", "t1", "t2"], ["zzz-oov"], [], [f"t{V - 1}"]]


@pytest.fixture(scope="module")
def int8_scorer():
    s = BayesianBM25Scorer(base_rate=0.01, impact_storage="int8")
    s.index(_corpus(), show_progress=False)
    assert s._split is not None and s._split.impact_scale is not None
    return s


class TestCoarseTier:
    def test_topk_agreement_high(self, int8_scorer):
        qs = _queries()
        ids_e, p_e = int8_scorer.retrieve(qs, k=10)
        ids_c, p_c = int8_scorer.retrieve(qs, k=10, coarse=True)
        # per-query top-10 set overlap: coarse reorders only near-ties.
        # This 600-doc corpus bunches scores within the ~0.8% coarse
        # error, so agreement here is a LOWER bound on serving scale
        # (chip_smoke.py reports the 50k-doc agreement on the GPU).
        overlaps = [
            len(set(ids_e[i]) & set(ids_c[i])) / 10 for i in range(len(qs))
        ]
        assert np.mean(overlaps) >= 0.8, np.mean(overlaps)
        assert np.all((p_c >= 0) & (p_c < 1))

    def test_score_error_class(self, int8_scorer):
        """Where the top-1 doc agrees, the coarse probability is within
        the documented ~1% score-error class of the exact one."""
        qs = _queries()
        ids_e, p_e = int8_scorer.retrieve(qs, k=1)
        ids_c, p_c = int8_scorer.retrieve(qs, k=1, coarse=True)
        same = (ids_e[:, 0] == ids_c[:, 0]) & (ids_e[:, 0] >= 0)
        assert same.any()
        np.testing.assert_allclose(p_c[same], p_e[same], rtol=0.15,
                                   atol=1e-3)

    def test_exact_storage_noop(self):
        s = BayesianBM25Scorer(base_rate=0.01)  # ctor default: hilo
        s.index(_corpus(), show_progress=False)
        qs = _queries()[:12]
        ids_e, p_e = s.retrieve(qs, k=5)
        ids_c, p_c = s.retrieve(qs, k=5, coarse=True)
        np.testing.assert_array_equal(ids_c, ids_e)
        np.testing.assert_array_equal(p_c, p_e)

    def test_composes_with_approx_and_mask(self, int8_scorer):
        qs = _queries()[:16]
        rng = np.random.default_rng(3)
        mask = rng.random(int8_scorer.num_docs) > 0.3
        ids, probs = int8_scorer.retrieve(qs, k=5, coarse=True,
                                          doc_mask=mask)
        alive = ids[ids >= 0]
        assert mask[alive].all()
        ids_a, _ = int8_scorer.retrieve(qs, k=5, coarse=True, approx=True)
        assert ids_a.shape == (len(qs), 5)

    def test_retrieve_many_parity(self, int8_scorer):
        qs = _queries()[:16]
        single = int8_scorer.retrieve(qs, k=5, coarse=True)
        many = int8_scorer.retrieve_many([qs], k=5, coarse=True)[0]
        np.testing.assert_array_equal(many[0], single[0])
        np.testing.assert_allclose(many[1], single[1], rtol=1e-6)
