"""Block-max (BMW) index: per-block per-term score maxima for safe pruning.

API parity with the reference BlockMaxIndex (scorer.py:33-142), built as
one device reduce: the (n_terms, n_docs) score matrix is padded to complete
blocks and max-reduced over the block axis in a single reshape+max — no
Python loop over blocks. Bayesian block bounds delegate to the transform's
WAND upper bound (Corollary 7.4.2).

``from_bm25_index`` builds block maxima directly from the engine's
doc-major term table (the production path — the dense (n_terms, n_docs)
matrix never materializes), and ``query_block_upper_bounds`` +
``prune_mask`` provide vectorized per-(query, block) Bayesian bounds for
block-skipping retrieval.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("block_size",))
def _block_max_dense(score_matrix, block_size: int):
    n_terms, n_docs = score_matrix.shape
    n_blocks = -(-n_docs // block_size)
    pad = n_blocks * block_size - n_docs
    padded = jnp.pad(score_matrix, ((0, 0), (0, pad)),
                     constant_values=-jnp.inf)
    return jnp.max(padded.reshape(n_terms, n_blocks, block_size), axis=2)


class BlockMaxIndex:
    """Per-block per-term BM25 maxima (blocks of ``block_size`` docs)."""

    def __init__(self, block_size: int = 128) -> None:
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self._block_size = block_size
        self._block_maxes: np.ndarray | None = None
        self._n_docs = 0
        self._n_terms = 0

    def build(self, score_matrix) -> None:
        """Build from a dense (n_terms, n_docs) per-term score matrix."""
        score_matrix = np.asarray(score_matrix, dtype=np.float64)
        if score_matrix.ndim != 2:
            raise ValueError(
                f"score_matrix must be 2D (n_terms, n_docs), got "
                f"{score_matrix.ndim}D"
            )
        self._n_terms, self._n_docs = score_matrix.shape
        self._block_maxes = np.asarray(
            _block_max_dense(score_matrix, self._block_size)
        ).astype(np.float64)

    @classmethod
    def from_bm25_index(cls, index, block_size: int = 128) -> "BlockMaxIndex":
        """Build from the engine's doc-major table without densifying.

        Scatter-max of the (D, T) weights into (n_terms, n_blocks): one
        segmented pass over the padded table.
        """
        self = cls(block_size)
        tids = np.asarray(index.term_ids)
        w = np.asarray(index.weights, dtype=np.float64)
        D = index.n_docs
        n_terms = index.n_terms
        n_blocks = -(-D // block_size)
        bm = np.zeros((n_terms, n_blocks), dtype=np.float64)
        doc_of_row = np.arange(tids.shape[0])
        block_of_row = doc_of_row // block_size
        valid = (tids >= 0) & (doc_of_row[:, None] < D)
        t_flat = tids[valid]
        b_flat = np.broadcast_to(block_of_row[:, None], tids.shape)[valid]
        np.maximum.at(bm, (t_flat, b_flat), w[valid])
        self._block_maxes = bm
        self._n_docs = D
        self._n_terms = n_terms
        return self

    def block_upper_bound(self, term_idx: int, block_id: int) -> float:
        if self._block_maxes is None:
            raise RuntimeError("Call build() before block_upper_bound().")
        return float(self._block_maxes[term_idx, block_id])

    def bayesian_block_upper_bound(self, term_idx: int, block_id: int,
                                   transform, p_max: float = 0.9) -> float:
        """Tight per-block Bayesian probability bound via the transform's
        WAND upper bound."""
        return float(transform.wand_upper_bound(
            self.block_upper_bound(term_idx, block_id), p_max
        ))

    @property
    def block_size(self) -> int:
        return self._block_size

    @property
    def n_blocks(self) -> int:
        if self._block_maxes is None:
            raise RuntimeError("Call build() before accessing n_blocks.")
        return self._block_maxes.shape[1]

    @property
    def block_maxes(self) -> np.ndarray:
        if self._block_maxes is None:
            raise RuntimeError("Call build() before accessing block_maxes.")
        return self._block_maxes

    # -- vectorized pruning (extensions) -------------------------------------

    def query_block_upper_bounds(self, term_indices, transform,
                                 p_max: float = 0.9) -> np.ndarray:
        """Per-block Bayesian upper bound for a query: the WAND bound of the
        sum of the query terms' block maxima — safe because every doc's
        score within a block is bounded by that sum."""
        if self._block_maxes is None:
            raise RuntimeError("Call build() before pruning.")
        terms = np.asarray(term_indices, dtype=int)
        score_ub = self._block_maxes[terms].sum(axis=0)
        return np.asarray(transform.wand_upper_bound(score_ub, p_max))

    def prune_mask(self, term_indices, transform, threshold: float,
                   p_max: float = 0.9) -> np.ndarray:
        """Boolean keep-mask over blocks: bound >= threshold."""
        return self.query_block_upper_bounds(term_indices, transform, p_max) \
            >= threshold
