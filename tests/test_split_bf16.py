"""bfloat16 impact-matrix option (large-corpus memory mode).

Past _SPLIT_INT8_MIN_DOCS the scorer stores the frequent-term impact
matrix as an (hi, lo) int8 pair with per-doc scales (presence is always
bf16 — 0/1 is exact there); single-bf16 remains the opt-in
`impact_storage="bf16"` tier these tests characterize. They pin the
tolerance story: per-element rounding is bounded by bf16's 2^-8
relative step, rankings stay intact on a realistic corpus, and the
sparse-candidate path remains internally consistent (its exactness
argument needs only non-negativity, which rounding preserves)."""

import numpy as np
import pytest

import jax.numpy as jnp

from bayesian_bm25_tpu import BayesianBM25Scorer
from bayesian_bm25_tpu.engine import index as eidx
from bayesian_bm25_tpu.engine import split_index as sidx


@pytest.fixture(scope="module")
def corpus_and_queries():
    rng = np.random.default_rng(0)
    corpus = [[f"t{t}" for t in rng.zipf(1.3, size=60) % 3000]
              for _ in range(3000)]
    queries = [[f"t{t}" for t in rng.zipf(1.3, size=6) % 3000]
               for _ in range(64)]
    return corpus, queries


def build_pair(corpus):
    idx = eidx.build_index(corpus)
    f32 = sidx.build_split_index(idx, n_frequent=512, dtype=jnp.float32)
    bf16 = sidx.build_split_index(idx, n_frequent=512, dtype=jnp.bfloat16)
    return idx, f32, bf16


class TestBf16Tolerance:
    def test_scores_within_bf16_step(self, corpus_and_queries):
        corpus, queries = corpus_and_queries
        idx, s32, s16 = build_pair(corpus)
        enc = sidx.encode_queries_split(queries, s32)
        a, _ = sidx.score_all_split(s32, *enc)
        b, _ = sidx.score_all_split(s16, *enc)
        a, b = np.asarray(a), np.asarray(b)
        # bf16 has an 8-bit mantissa: each stored impact rounds within
        # 2^-9 relative; sums of same-sign terms keep that bound.
        np.testing.assert_allclose(b, a, rtol=2 ** -8, atol=1e-6)

    def test_rankings_stable(self, corpus_and_queries):
        corpus, queries = corpus_and_queries
        idx, s32, s16 = build_pair(corpus)
        k = 10
        enc = sidx.encode_queries_split(queries, s32)
        fslots, fcnt, trows, tqids, tqcnt = enc
        tslots = sidx.map_tail_slots(tqids, s32)
        args = (jnp.asarray(fslots), jnp.asarray(fcnt), jnp.asarray(trows),
                jnp.asarray(tslots), jnp.asarray(tqcnt))

        def run(s):
            cap = sidx.candidate_cap(s, tslots, k)
            ids, probs, _, _ = sidx.retrieve_topk_split_sparse(
                s.dense_impact, s.dense_presence, s.post_doc_ids,
                s.post_weights, idx.doc_lengths, idx.avgdl, *args, k, cap,
                1.0, 2.0, 0.05, n_docs=idx.n_docs)
            return np.asarray(ids), np.asarray(probs)

        ids32, probs32 = run(s32)
        ids16, probs16 = run(s16)
        # top-10 sets overlap almost entirely; probabilities track
        overlaps = [len(set(ids32[i]) & set(ids16[i])) / k
                    for i in range(len(ids32))]
        assert np.mean(overlaps) > 0.95
        m = ids32 == ids16
        np.testing.assert_allclose(probs16[m], probs32[m], rtol=2e-2,
                                   atol=1e-4)

    def test_tf_exact_in_bf16(self, corpus_and_queries):
        """Presence / tf counts are integers — bf16 keeps them exact."""
        corpus, queries = corpus_and_queries
        idx, s32, s16 = build_pair(corpus)
        enc = sidx.encode_queries_split(queries, s32)
        _, tf32 = sidx.score_all_split(s32, *enc)
        _, tf16 = sidx.score_all_split(s16, *enc)
        np.testing.assert_array_equal(np.asarray(tf32), np.asarray(tf16))

    def test_bf16_weights_stay_nonnegative(self, corpus_and_queries):
        """The sparse-candidate exactness argument needs contributions
        >= 0; bf16 rounding of non-negative values preserves that."""
        corpus, _ = corpus_and_queries
        _, _, s16 = build_pair(corpus)
        assert float(jnp.min(s16.dense_impact)) >= 0.0
        assert float(jnp.min(s16.post_weights)) >= 0.0

    def test_scorer_auto_selects_dtype(self):
        rng = np.random.default_rng(1)
        small = [[f"t{t}" for t in rng.integers(0, 500, 12)]
                 for _ in range(300)]
        s = BayesianBM25Scorer()
        s.index(small, show_progress=False)
        # default matmul_precision="high" -> hi/lo bf16 pair storage
        assert s._split.dense_impact.dtype == jnp.bfloat16
        assert s._split.dense_impact_lo is not None
        assert s._split.dense_impact_lo.dtype == jnp.bfloat16
        # "highest" keeps the f32 matrix (bit-equal to the compare path)
        sh = BayesianBM25Scorer(matmul_precision="highest")
        sh.index(small, show_progress=False)
        assert sh._split.dense_impact.dtype == jnp.float32
        assert sh._split.dense_impact_lo is None
        # threshold behavior is by padded doc count; patch the constant
        # down instead of building 262k docs. Past the threshold the
        # auto storage is the int8 (hi, lo) pair: same bytes as single
        # bf16, ~20x lower error.
        s2 = BayesianBM25Scorer()
        s2._SPLIT_INT8_MIN_DOCS = 64
        s2.index(small, show_progress=False)
        assert s2._split.dense_impact.dtype == jnp.int8
        assert s2._split.dense_impact_lo is not None
        assert s2._split.dense_impact_lo.dtype == jnp.int8
        assert s2._split.impact_scale is not None
        assert s2._split.dense_presence.dtype == jnp.bfloat16
        i1, p1 = s.retrieve([small[0][:4]], k=5)
        i2, p2 = s2.retrieve([small[0][:4]], k=5)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(p1, p2, rtol=2e-2, atol=1e-4)


class TestMatmulPrecisionKnob:
    """matmul_precision is a serving knob; on the CPU test backend
    every setting computes identical f32 results, so these tests pin the
    API surface (validation, pass-through compile, cross-setting
    agreement) rather than the GPU algorithms (chip_smoke.py measures
    those on the card)."""

    def test_invalid_raises(self):
        with pytest.raises(ValueError, match="matmul_precision"):
            BayesianBM25Scorer(matmul_precision="turbo")

    @pytest.mark.parametrize("prec", ["highest", "high", "default"])
    def test_settings_agree_on_cpu(self, corpus_and_queries, prec):
        corpus, queries = corpus_and_queries
        s = BayesianBM25Scorer(matmul_precision=prec)
        s.index(corpus[:500], show_progress=False)
        ids, probs = s.retrieve(queries[:8], k=5)
        ref = BayesianBM25Scorer(matmul_precision="highest")
        ref.index(corpus[:500], show_progress=False)
        ids_r, probs_r = ref.retrieve(queries[:8], k=5)
        if prec == "highest":
            np.testing.assert_array_equal(ids, ids_r)
            np.testing.assert_allclose(probs, probs_r, rtol=1e-4)
        else:
            # "high" is hi/lo-bf16 storage (~8e-6 score perturbation,
            # even on CPU) and "default" is 1-pass: ranks may swap
            # between near-tied docs, but the probability profile must
            # agree and any id difference must be a near-tie swap.
            np.testing.assert_allclose(probs, probs_r, rtol=2e-3,
                                       atol=1e-6)
            # most positions still agree exactly; only near-ties may swap
            assert (ids == ids_r).mean() > 0.8
