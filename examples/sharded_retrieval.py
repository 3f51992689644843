"""Multi-device document-sharded retrieval.

Runs on the real devices when JAX sees at least 2, and on an 8-device
virtual CPU mesh only when ``--virtual-cpu`` asks for it. Prints which
one it ran on.

    python examples/sharded_retrieval.py [--virtual-cpu]
"""

import os
import sys

VIRTUAL = "--virtual-cpu" in sys.argv
if VIRTUAL:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not VIRTUAL and len(jax.devices()) < 2:
    sys.exit(f"only {len(jax.devices())} device(s); sharding needs at "
             "least 2 (pass --virtual-cpu for an 8-device CPU mesh)")

import numpy as np  # noqa: E402

from bayesian_bm25_tpu.engine import index as eidx  # noqa: E402
from bayesian_bm25_tpu.parallel import sharded  # noqa: E402

n_dev = len(jax.devices())
kind = ("virtual CPU mesh" if VIRTUAL
        else f"real devices ({jax.devices()[0].device_kind})")
print(f"devices: {n_dev} x {jax.devices()[0].platform} — {kind}")

rng = np.random.default_rng(0)
corpus = [[f"t{t}" for t in rng.integers(0, 500, 40)] for _ in range(64)]
idx = eidx.build_index(corpus, doc_pad_multiple=n_dev, pad_multiple=8)

mesh = sharded.make_mesh()
tids, w, dl = sharded.shard_index_arrays(
    mesh, idx.term_ids, idx.weights, idx.doc_lengths)
print(f"term table {idx.term_ids.shape} sharded over mesh {mesh.shape}")

queries = [[f"t{t}" for t in rng.integers(0, 500, 5)] for _ in range(4)]
qids, qcnt = eidx.encode_queries(queries, idx.vocab)

ids, probs, scores = sharded.sharded_retrieve_topk(
    mesh, tids, w, dl, idx.avgdl, qids, qcnt, k=5,
    alpha=1.0, beta=2.0, base_rate=0.05,
)
print("\nper-shard top-k + all_gather merge results:")
for qi in range(len(queries)):
    print(f"  q{qi}: docs {np.asarray(ids)[qi].tolist()} "
          f"probs {np.round(np.asarray(probs)[qi], 3).tolist()}")

n, avgdl, df = sharded.corpus_stats_psum(mesh, dl, tids, idx.n_terms)
print(f"\npsum corpus stats: N={int(n)} avgdl={float(avgdl):.2f} "
      f"df checksum={int(np.asarray(df).sum())}")

# --- the user-facing form: ShardedBayesianBM25Scorer --------------------
# Same API as the single-device scorer; index arrays are document-sharded
# over the mesh, retrieval merges per-shard top-k with collectives.
from bayesian_bm25_tpu import ShardedBayesianBM25Scorer  # noqa: E402

scorer = ShardedBayesianBM25Scorer(mesh=mesh, base_rate="auto")
scorer.index(corpus, show_progress=False)
s_ids, s_probs = scorer.retrieve(queries, k=5)
print(f"\nShardedBayesianBM25Scorer (auto base_rate="
      f"{scorer.base_rate:.2e}):")
for qi in range(len(queries)):
    print(f"  q{qi}: docs {s_ids[qi].tolist()} "
          f"probs {np.round(s_probs[qi], 3).tolist()}")

scorer.add_documents([["t1", "t2", "freshly", "added"]])
print(f"\nafter incremental add_documents: {scorer.num_docs} docs, "
      f"retrieval still live:",
      scorer.retrieve([["freshly"]], k=1)[0].tolist())
