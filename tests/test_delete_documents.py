"""delete_documents / restore_documents: tombstone lifecycle.

Extension (the reference supports add_documents only):
tombstoned docs are excluded from every query path without an index
rebuild, ids stay stable, and the mask composes with caller doc_mask,
survives checkpoints, and extends across add_documents."""

import numpy as np
import pytest

import jax

from bayesian_bm25_tpu import BayesianBM25Scorer


@pytest.fixture()
def scorer():
    rng = np.random.default_rng(13)
    corpus = [[f"t{t}" for t in rng.zipf(1.4, size=rng.integers(5, 30))
               % 400] for _ in range(250)]
    s = BayesianBM25Scorer(base_rate="auto")
    s.index(corpus, show_progress=False)
    return s, corpus


class TestRetrieveExclusion:
    def test_deleted_never_returned(self, scorer):
        s, corpus = scorer
        queries = [corpus[i][:5] for i in range(0, 60, 7)]
        ids0, _ = s.retrieve(queries, k=10)
        victims = set(int(d) for d in np.asarray(ids0)[:, 0] if d >= 0)
        s.delete_documents(sorted(victims))
        ids1, _ = s.retrieve(queries, k=10)
        assert not (set(np.asarray(ids1).ravel().tolist()) & victims)

    def test_matches_explicit_doc_mask(self, scorer):
        s, corpus = scorer
        queries = [corpus[i][:5] for i in range(0, 40, 9)]
        mask = np.ones(s.num_docs, bool)
        mask[::3] = False
        mask2 = np.ones(s.num_docs, bool)
        mask2[1::3] = False
        # references BEFORE any tombstones exist
        ref_ids, ref_probs = s.retrieve(queries, k=8, doc_mask=mask)
        ref2, _ = s.retrieve(queries, k=8, doc_mask=mask & mask2)
        s.delete_documents(np.flatnonzero(~mask))
        got_ids, got_probs = s.retrieve(queries, k=8)
        np.testing.assert_array_equal(np.asarray(ref_ids),
                                      np.asarray(got_ids))
        np.testing.assert_array_equal(np.asarray(ref_probs),
                                      np.asarray(got_probs))
        # caller mask composes (AND) with tombstones
        got2, _ = s.retrieve(queries, k=8, doc_mask=mask2)
        np.testing.assert_array_equal(np.asarray(ref2),
                                      np.asarray(got2))

    def test_restore_and_idempotence(self, scorer):
        s, corpus = scorer
        q = [corpus[7][:5]]
        base_ids, _ = s.retrieve(q, k=5)
        s.delete_documents([3, 3, 5])
        s.delete_documents([5])  # idempotent
        assert s.deleted_mask.sum() == 2
        s.restore_documents([3, 5])
        assert s.deleted_mask is None
        ids, _ = s.retrieve(q, k=5)
        np.testing.assert_array_equal(np.asarray(base_ids),
                                      np.asarray(ids))

    def test_validation(self, scorer):
        s, _ = scorer
        with pytest.raises(ValueError):
            s.delete_documents([s.num_docs])
        with pytest.raises(ValueError):
            s.delete_documents([-1])
        with pytest.raises(RuntimeError):
            BayesianBM25Scorer().delete_documents([0])


class TestDensePaths:
    def test_scores_and_probs_zeroed(self, scorer):
        s, corpus = scorer
        q = [corpus[2][:5]]
        s.delete_documents([0, 10, 20])
        scores = s.get_scores_batch(q)
        probs = s.get_probabilities_batch(q)
        assert (scores[:, [0, 10, 20]] == 0).all()
        assert (probs[:, [0, 10, 20]] == 0).all()

    def test_thresholded_excludes(self, scorer):
        s, corpus = scorer
        q = [corpus[4][:5]]
        ids0, _, n0 = s.retrieve_thresholded(q, threshold=1e-4, k=10)
        alive = [int(d) for d in ids0[0] if d >= 0]
        if not alive:
            pytest.skip("no passing docs at this threshold")
        s.delete_documents(alive[:1])
        ids1, _, n1 = s.retrieve_thresholded(q, threshold=1e-4, k=10)
        assert alive[0] not in set(int(d) for d in ids1[0])
        assert n1[0] == n0[0] - 1


class TestLifecycle:
    def test_add_documents_extends_mask(self, scorer):
        s, corpus = scorer
        s.delete_documents([1])
        n_before = s.num_docs
        s.add_documents(corpus[:4], show_progress=False)
        assert s.num_docs == n_before + 4
        assert s.deleted_mask.shape == (s.num_docs,)
        assert s.deleted_mask.sum() == 1 and s.deleted_mask[1]
        ids, _ = s.retrieve([corpus[1][:6]], k=10)
        assert 1 not in set(int(d) for d in np.asarray(ids)[0])

    def test_reindex_clears_mask(self, scorer):
        s, corpus = scorer
        s.delete_documents([2])
        s.index(corpus, show_progress=False)
        assert s.deleted_mask is None

    def test_checkpoint_round_trip(self, scorer, tmp_path):
        from bayesian_bm25_tpu.utils.io import load_scorer, save_scorer
        s, corpus = scorer
        s.delete_documents([7, 9])
        path = str(tmp_path / "del.npz")
        save_scorer(path, s)
        s2 = load_scorer(path)
        np.testing.assert_array_equal(s2.deleted_mask, s.deleted_mask)
        q = [corpus[7][:5]]
        np.testing.assert_array_equal(np.asarray(s.retrieve(q, k=5)[0]),
                                      np.asarray(s2.retrieve(q, k=5)[0]))


class TestMultiFieldDelete:
    def test_fused_zero_and_ranking(self):
        from bayesian_bm25_tpu import MultiFieldScorer
        rng = np.random.default_rng(21)
        docs = [{"title": [f"t{t}" for t in rng.integers(0, 60, 4)],
                 "body": [f"t{t}" for t in rng.integers(0, 200, 25)]}
                for _ in range(80)]
        mf = MultiFieldScorer(fields=["title", "body"])
        mf.index(docs, show_progress=False)
        q = docs[3]["body"][:5]
        top0, probs0 = mf.retrieve(q, k=5)
        victim = int(top0[0])
        mf.delete_documents([victim])
        top1, probs1 = mf.retrieve(q, k=5)
        assert victim not in set(int(d) for d in top1)
        assert mf.get_probabilities(q)[victim] == 0.0
        assert mf.get_probabilities_batch([q])[0, victim] == 0.0
        mf.restore_documents([victim])
        assert mf.deleted_mask is None
        top2, _ = mf.retrieve(q, k=5)
        assert int(top2[0]) == victim


@pytest.mark.skipif(len(jax.devices()) < 8,
                    reason="needs 8 virtual devices")
class TestShardedDelete:
    def test_sharded_matches_single(self):
        from bayesian_bm25_tpu import ShardedBayesianBM25Scorer
        rng = np.random.default_rng(19)
        corpus = [[f"t{t}" for t in rng.integers(0, 300,
                                                 rng.integers(3, 25))]
                  for _ in range(200)]
        queries = [corpus[i][:5] for i in range(0, 40, 7)]
        single = BayesianBM25Scorer(base_rate="auto")
        single.index(corpus, show_progress=False)
        sh = ShardedBayesianBM25Scorer(base_rate="auto", n_devices=8)
        sh.index(corpus, show_progress=False)
        for sc in (single, sh):
            sc.delete_documents([0, 5, 11, 190])
        ids_a, _ = single.retrieve(queries, k=7)
        ids_b, _ = sh.retrieve(queries, k=7)
        np.testing.assert_array_equal(np.asarray(ids_a),
                                      np.asarray(ids_b))
        assert not ({0, 5, 11, 190}
                    & set(np.asarray(ids_b).ravel().tolist()))
