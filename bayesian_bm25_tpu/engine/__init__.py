"""Owned BM25 engine: tokenizer, device-resident index, scoring kernels.

Replaces the reference's external ``bm25s`` backend (scorer.py:20-26) with a
device engine: host-side vocab/statistics build, a doc-major padded term
table in HBM, and batched XLA scoring kernels that fuse BM25
accumulation with the unique-overlap tf feature and the Bayesian probability
transform.
"""
