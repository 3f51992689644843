"""Blockwise exact top-k (engine/split_index.py:exact_topk_blockwise) and
its XLA block-max reduce: parity with ``lax.top_k`` and with the plain
masked reshape-max, including pad columns (``valid_upto``), -inf
(doc_mask) entries, and the lowest-id tie order."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bayesian_bm25_tpu.engine import split_index as sidx


@pytest.fixture(scope="module")
def scores():
    rng = np.random.default_rng(3)
    return jnp.asarray(rng.normal(size=(32, 2048)).astype(np.float32))


def _masked_reshape_max(s, block, vu):
    nq, d = s.shape
    masked = jnp.where(jnp.arange(d)[None] < vu, s, -jnp.inf)
    return masked.reshape(nq, d // block, block).max(axis=2)


class TestBlockMax:
    def test_matches_reshape_max(self, scores):
        nq, d = scores.shape
        out = sidx._block_max(scores.reshape(nq, d // 256, 256), None)
        ref = scores.reshape(nq, d // 256, 256).max(axis=2)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))

    @pytest.mark.parametrize("vu", [2048, 2000, 1792, 300, 1])
    def test_valid_upto_masks(self, scores, vu):
        nq, d = scores.shape
        out = sidx._block_max(scores.reshape(nq, d // 256, 256), vu)
        np.testing.assert_array_equal(
            np.asarray(out), np.asarray(_masked_reshape_max(scores, 256, vu)))

    def test_neg_inf_entries_pass_through(self, scores):
        s2 = scores.at[:, ::3].set(-jnp.inf)
        nq, d = s2.shape
        out = sidx._block_max(s2.reshape(nq, d // 256, 256), 2000)
        np.testing.assert_array_equal(
            np.asarray(out), np.asarray(_masked_reshape_max(s2, 256, 2000)))


class TestBlockwiseTopk:
    @pytest.mark.parametrize("vu", [2048, 2000, 1792, 300])
    def test_topk_matches_lax(self, scores, vu):
        k = min(5, vu)
        rv, ri = jax.lax.top_k(scores[:, :vu], k)
        bv, bi = sidx.exact_topk_blockwise(scores, k, block=256,
                                           valid_upto=vu)
        np.testing.assert_array_equal(np.asarray(bv), np.asarray(rv))
        np.testing.assert_array_equal(np.asarray(bi), np.asarray(ri))

    def test_with_doc_mask_neg_inf(self, scores):
        s2 = scores.at[:, ::3].set(-jnp.inf)
        rv, ri = jax.lax.top_k(s2[:, :2000], 5)
        bv, bi = sidx.exact_topk_blockwise(s2, 5, block=256,
                                           valid_upto=2000)
        np.testing.assert_array_equal(np.asarray(bv), np.asarray(rv))
        np.testing.assert_array_equal(np.asarray(bi), np.asarray(ri))

    def test_odd_row_count(self):
        rng = np.random.default_rng(5)
        s3 = jnp.asarray(rng.normal(size=(7, 1024)).astype(np.float32))
        rv, ri = jax.lax.top_k(s3[:, :1000], 3)
        bv, bi = sidx.exact_topk_blockwise(s3, 3, block=256,
                                           valid_upto=1000)
        np.testing.assert_array_equal(np.asarray(bv), np.asarray(rv))
        np.testing.assert_array_equal(np.asarray(bi), np.asarray(ri))

    def test_tie_break_prefers_lower_id(self):
        s = jnp.zeros((8, 1024), jnp.float32)
        s = s.at[:, [3, 700, 900]].set(1.0)
        bv, bi = sidx.exact_topk_blockwise(s, 4, block=256,
                                           valid_upto=1000)
        rv, ri = jax.lax.top_k(s[:, :1000], 4)
        np.testing.assert_array_equal(np.asarray(bi), np.asarray(ri))
        np.testing.assert_array_equal(np.asarray(bv), np.asarray(rv))

    def test_unpadded_width_pads_with_neg_inf(self):
        # No valid_upto: a width that is not a block multiple is padded
        # with -inf, so pad columns can never be selected.
        rng = np.random.default_rng(6)
        s = jnp.asarray(rng.normal(size=(4, 1000)).astype(np.float32))
        rv, ri = jax.lax.top_k(s, 6)
        bv, bi = sidx.exact_topk_blockwise(s, 6, block=128)
        np.testing.assert_array_equal(np.asarray(bv), np.asarray(rv))
        np.testing.assert_array_equal(np.asarray(bi), np.asarray(ri))

    def test_few_blocks_falls_back_to_dense(self, scores):
        # k >= number of blocks: the prefilter would keep everything.
        rv, ri = jax.lax.top_k(scores[:, :1500], 8)
        bv, bi = sidx.exact_topk_blockwise(scores, 8, block=256,
                                           valid_upto=1500)
        np.testing.assert_array_equal(np.asarray(bv), np.asarray(rv))
        np.testing.assert_array_equal(np.asarray(bi), np.asarray(ri))

    def test_valid_upto_needs_block_multiple(self):
        s = jnp.zeros((2, 1000), jnp.float32)
        with pytest.raises(ValueError, match="D % block"):
            sidx.exact_topk_blockwise(s, 2, block=256, valid_upto=900)

    def test_all_masked_rows_match_lax(self):
        s = jnp.full((3, 1024), -jnp.inf, jnp.float32)
        s = s.at[1, 512].set(2.0)
        rv, ri = jax.lax.top_k(s[:, :1000], 4)
        bv, bi = sidx.exact_topk_blockwise(s, 4, block=256,
                                           valid_upto=1000)
        np.testing.assert_array_equal(np.asarray(bv), np.asarray(rv))
        np.testing.assert_array_equal(np.asarray(bi), np.asarray(ri))


class TestLargeWidth:
    """Widths of a 1M-doc chunk's order: many blocks per row."""

    def test_block_max_parity_with_mask(self):
        rng = np.random.default_rng(9)
        nq, d, b = 16, 1 << 17, 256
        s = jnp.asarray(rng.normal(size=(nq, d)).astype(np.float32))
        vu = d - 777
        out = sidx._block_max(s.reshape(nq, d // b, b), vu)
        np.testing.assert_array_equal(
            np.asarray(out), np.asarray(_masked_reshape_max(s, b, vu)))

    def test_topk_through_blockwise(self):
        rng = np.random.default_rng(10)
        nq, d, b = 16, 1 << 17, 256
        s = jnp.asarray(rng.normal(size=(nq, d)).astype(np.float32))
        vu = d - 100
        rv, ri = jax.lax.top_k(s[:, :vu], 4)
        bv, bi = sidx.exact_topk_blockwise(s, 4, block=b, valid_upto=vu)
        np.testing.assert_array_equal(np.asarray(bv), np.asarray(rv))
        np.testing.assert_array_equal(np.asarray(bi), np.asarray(ri))
