"""End-to-end serving demo: raw text in -> calibrated results out, with
throughput/latency statistics (extension example)."""

import time

import numpy as np

from bayesian_bm25_tpu import BayesianBM25Scorer

rng = np.random.default_rng(0)
vocab = [f"term{i}" for i in range(5000)]
texts = [" ".join(rng.choice(vocab, size=60)) for _ in range(5000)]

scorer = BayesianBM25Scorer(base_rate=0.01)
t0 = time.perf_counter()
scorer.index_texts(texts)
print(f"indexed {scorer.num_docs} raw-text docs in "
      f"{time.perf_counter()-t0:.1f}s "
      f"(split index: {'on' if scorer._split is not None else 'off'})")

queries = [" ".join(rng.choice(vocab, size=5)) for _ in range(256)]
scorer.retrieve_texts(queries, k=10)  # warm / compile

for batch in (1, 16, 256):
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        ids, probs = scorer.retrieve_texts(queries[:batch], k=10)
    dt = (time.perf_counter() - t0) / reps
    print(f"batch {batch:>3}: {dt*1000:7.1f} ms "
          f"({batch/dt:8.0f} queries/sec)")

# Steady-state serving: retrieve_many launches every batch's encode +
# kernel before pulling any result, overlapping host work and transfers
# with device compute — the double-buffered regime a busy server runs
# in (values are identical to per-call retrieve).
from bayesian_bm25_tpu.engine.tokenize import tokenize_texts

tok_batches = [tokenize_texts(queries[:256]) for _ in range(4)]
scorer.retrieve_many(tok_batches[:1], k=10)  # warm
t0 = time.perf_counter()
outs = scorer.retrieve_many(tok_batches, k=10)
dt = time.perf_counter() - t0
total = sum(len(b) for b in tok_batches)
print(f"pipelined {len(tok_batches)} batches: "
      f"{total/dt:8.0f} queries/sec steady-state")

ids, probs = scorer.retrieve_texts(["term1 term2 term3"], k=3)
print(f"\nsample result: docs {ids[0].tolist()} "
      f"probs {np.round(probs[0], 3).tolist()}")
print("calibrated probabilities mean a fixed threshold works across "
      "queries:")
ids, probs, n_passing = scorer.retrieve_thresholded(
    [q.split() for q in queries[:4]], threshold=0.5, k=5)
for i in range(4):
    print(f"  query {i}: {n_passing[i]} docs above P>=0.5")
