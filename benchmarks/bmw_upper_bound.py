"""Block-max (BMW) bounds: block vs global tightness, pruning rate,
block-size sensitivity, safety check
(reference: benchmarks/bmw_upper_bound.py).

Usage: python benchmarks/bmw_upper_bound.py
"""

from __future__ import annotations

import sys

import numpy as np

sys.path.insert(0, ".")

from bayesian_bm25_tpu import BayesianBM25Scorer, BlockMaxIndex  # noqa: E402
from bayesian_bm25_tpu.engine.tokenize import tokenize_texts  # noqa: E402
from benchmarks.common import print_table  # noqa: E402
from benchmarks.utils import synthetic_dataset  # noqa: E402


def main():
    ds = synthetic_dataset(n_docs=2000, n_queries=24)
    corpus_tokens = tokenize_texts([ds.corpus[d] for d in ds.doc_ids])
    query_tokens = tokenize_texts(list(ds.queries.values()))
    scorer = BayesianBM25Scorer(method="lucene", base_rate="auto")
    scorer.index(corpus_tokens, show_progress=False)
    idx = scorer.bm25_index
    tr = scorer.transform

    rows = []
    for block_size in (64, 128, 256, 512):
        bmi = BlockMaxIndex.from_bm25_index(idx, block_size=block_size)
        bm = bmi.block_maxes
        global_max = bm.max(axis=1)

        # tightness: mean block bound / global bound over populated cells
        populated = bm > 0
        with np.errstate(invalid="ignore", divide="ignore"):
            ratio = np.where(
                populated, bm / np.maximum(global_max[:, None], 1e-12), np.nan)
        tightness = float(np.nanmean(ratio))

        # pruning rate at a mid threshold, plus exactness check
        threshold = 0.8
        pruned = 0
        total_blocks = 0
        unsafe = 0
        for qt in query_tokens[:12]:
            terms = [idx.vocab[t] for t in qt if t in idx.vocab]
            if not terms:
                continue
            keep = bmi.prune_mask(terms, tr, threshold)
            total_blocks += len(keep)
            pruned += int((~keep).sum())
            probs = scorer.get_probabilities(qt)
            for blk in np.where(~keep)[0]:
                lo, hi = blk * block_size, min((blk + 1) * block_size,
                                               idx.n_docs)
                if probs[lo:hi].max(initial=0.0) >= threshold:
                    unsafe += 1
        rows.append((block_size, bmi.n_blocks, round(tightness, 4),
                     round(pruned / max(total_blocks, 1), 3), unsafe))

    print_table(
        "Block-max bounds (threshold 0.8 pruning)", rows,
        ("block size", "n blocks", "block/global tightness",
         "pruned frac", "unsafe"),
    )

    # --- thresholded retrieval: single dense pass vs double pass --------
    # The shipped retrieve_thresholded is ONE fused dense pass (scores ->
    # transform -> masked top-k + count). The round-1 implementation did a
    # top-k retrieve AND a dense pass; block skipping cannot beat the
    # single pass here because the frequent-term matmul computes every
    # doc's score regardless (matmul work is data-independent under XLA) —
    # the bounds' pruned-frac above quantifies what a gather-based skip
    # could save on the compare path only (see docs/design.md §8).
    import time

    qts = query_tokens[:16]
    scorer.retrieve_thresholded(qts, 0.8, k=10)  # warm
    t0 = time.perf_counter()
    for _ in range(5):
        ids, probs, n_passing = scorer.retrieve_thresholded(qts, 0.8, k=10)
    t_single = (time.perf_counter() - t0) / 5

    def double_pass():
        i, p = scorer.retrieve(qts, k=10)
        dense = scorer.get_probabilities_batch(qts)
        return (dense >= 0.8).sum(axis=1)

    double_pass()
    t0 = time.perf_counter()
    for _ in range(5):
        double_pass()
    t_double = (time.perf_counter() - t0) / 5
    print(f"\nthresholded retrieval: single fused pass "
          f"{t_single * 1000:.1f} ms vs retrieve+dense double pass "
          f"{t_double * 1000:.1f} ms  ({t_double / t_single:.2f}x)")


if __name__ == "__main__":
    main()
