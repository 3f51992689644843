"""Index lifecycle demo: incremental adds, tombstone deletes, checkpoint
round-trip, and streaming retrieval (extension example —
the reference supports add_documents only; reference scorer lifecycle:
/root/reference/bayesian_bm25/scorer.py:469-492)."""

import os
import tempfile

import numpy as np

from bayesian_bm25_tpu import BayesianBM25Scorer
from bayesian_bm25_tpu.utils.io import load_scorer, save_scorer

rng = np.random.default_rng(0)
vocab = [f"term{i}" for i in range(2000)]
corpus = [list(rng.choice(vocab, size=30)) for _ in range(1000)]

scorer = BayesianBM25Scorer(base_rate="auto")
scorer.index(corpus, show_progress=False)
print(f"indexed {scorer.num_docs} docs "
      f"(alpha={scorer.transform.alpha:.3f})")

query = corpus[42][:6]
ids, probs = scorer.retrieve([query], k=5)
print("top-5:", ids[0].tolist(), np.round(probs[0], 4).tolist())

# --- incremental add: only the new docs are tokenized/counted --------
scorer.add_documents([list(rng.choice(vocab, size=30)) for _ in range(50)],
                     show_progress=False)
print(f"after add_documents: {scorer.num_docs} docs "
      f"(re-calibrated alpha={scorer.transform.alpha:.3f})")

# --- tombstone deletes: no rebuild, ids stay stable -------------------
victim = int(ids[0][0])
scorer.delete_documents([victim])
ids2, _ = scorer.retrieve([query], k=5)
assert victim not in ids2[0].tolist()
print(f"deleted doc {victim}: top-5 now {ids2[0].tolist()}")

scorer.restore_documents([victim])
ids3, _ = scorer.retrieve([query], k=5)
assert int(ids3[0][0]) == victim
print(f"restored doc {victim}: back at rank 0")

# --- checkpoint round-trip (tombstones + kernel config persist) ------
scorer.delete_documents([victim])
with tempfile.TemporaryDirectory() as td:
    path = os.path.join(td, "scorer.npz")
    save_scorer(path, scorer)
    reloaded = load_scorer(path)
    ids4, _ = reloaded.retrieve([query], k=5)
    assert victim not in ids4[0].tolist()
    print(f"checkpoint round-trip: {os.path.getsize(path) / 1e6:.1f} MB, "
          f"tombstones intact")

# --- streaming pipelined serving --------------------------------------
batches = ([corpus[i][:5] for i in range(j, j + 8)]
           for j in range(0, 64, 8))
for n, (bids, bprobs) in enumerate(
        reloaded.retrieve_stream(batches, k=3, lookahead=2)):
    if n < 2:
        print(f"stream batch {n}: first ids {bids[0].tolist()}")
print("streamed 8 batches with a 2-batch device lookahead")
