"""Headline benchmark: batched-query retrieval throughput on one GPU.

Measures end-to-end retrieve(top-10 with calibrated probabilities) on a
synthetic Zipf corpus (50k docs / 30k vocab — the scalability.py regime of
the reference) and compares against a faithful CPU reference baseline:
scipy-CSR BM25 scoring + numpy transform, i.e. the same architecture as the
reference's bm25s backend (sparse matrix scoring on the host,
scorer.py:20-26).

Refuses to run unless JAX's first device is a GPU. Prints the card's name
and power limit on stderr, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", ...}.
"""

import json
import subprocess
import sys
import time

import numpy as np


def corpus_term_ids(rng, n_docs=50_000, doc_len=150, vocab=30_000):
    """(n_docs, doc_len) Zipf(1.3) term ids: the corpus as integers."""
    return rng.zipf(1.3, size=(n_docs, doc_len)) % vocab


def query_term_ids(rng, n=8192, qlen=8, vocab=30_000):
    """(n, qlen) Zipf(1.3) term ids, drawn one query at a time."""
    return np.stack([rng.zipf(1.3, size=qlen) % vocab for _ in range(n)])


def as_tokens(term_ids):
    """Integer term ids -> token lists ("t<id>"), the scorer's input."""
    return [[f"t{t}" for t in row] for row in term_ids]


def make_corpus(rng, n_docs=50_000, doc_len=150, vocab=30_000):
    return as_tokens(corpus_term_ids(rng, n_docs, doc_len, vocab))


def make_queries(rng, n=8192, qlen=8, vocab=30_000):
    # 8192-query batches amortize host<->device round trips and fill the
    # device (the batched serving regime this engine targets).
    return as_tokens(query_term_ids(rng, n, qlen, vocab))


def reference_probability(s, tf, r, alpha, beta, base_rate, eps=None):
    """float64 Bayesian transform: sigmoid likelihood, composite prior,
    two-step odds update with the base rate; 0 where the score is 0.
    ``eps`` clamps each step's probability to [eps, 1 - eps], as the
    package does (1e-6 in float32)."""
    def clip(p):
        return p if eps is None else np.clip(p, eps, 1 - eps)

    x = alpha * (s - beta)
    e = np.exp(-np.abs(x))
    L = np.where(x >= 0, 1 / (1 + e), e / (1 + e))
    Lc = np.where(x >= 0, e / (1 + e), 1 / (1 + e))
    p_tf = 0.2 + 0.7 * np.minimum(1, tf / 10)
    p_n = 0.3 + 0.6 * (1 - np.minimum(1, np.abs(r - 0.5) * 2))
    prior = np.clip(0.7 * p_tf + 0.3 * p_n, 0.1, 0.9)
    num, num_c = L * prior, Lc * (1 - prior)
    p1, p1_c = clip(num / (num + num_c)), clip(num_c / (num + num_c))
    if base_rate is None:
        return np.where(s > 0, p1, 0.0)
    num, num_c = p1 * base_rate, p1_c * (1 - base_rate)
    return np.where(s > 0, clip(num / (num + num_c)), 0.0)


class CpuReference:
    """CPU stand-in for the reference stack: a scipy CSR impact matrix
    (docs x vocab, Robertson BM25 weights, bm25s architecture) scored one
    query at a time, plus the float64 numpy Bayesian transform.

    Built from the corpus as an (n_docs, doc_len) integer term matrix;
    queries are (nq, qlen) integer term matrices. Independent of the
    package under test: it shares no code with it.
    """

    def __init__(self, doc_terms, k1=1.2, b=0.75):
        import scipy.sparse as sp

        doc_terms = np.asarray(doc_terms)
        n, L = doc_terms.shape
        # Unique terms per doc and their counts: sort each row, cut runs.
        srt = np.sort(doc_terms, axis=1)
        start = np.ones(srt.shape, dtype=bool)
        start[:, 1:] = srt[:, 1:] != srt[:, :-1]
        rows, cols = np.nonzero(start)
        flat = rows * L + cols
        tf = np.diff(np.append(flat, n * L)).astype(np.float64)
        terms = srt[rows, cols]
        V = int(doc_terms.max()) + 1
        df = np.bincount(terms, minlength=V).astype(np.float64)
        idf = np.maximum(np.log((n - df + 0.5) / (df + 0.5)), 0.0)
        self.dl = np.full(n, float(L))
        self.avgdl = self.dl.mean()
        Kd = k1 * (1 - b + b * self.dl / self.avgdl)
        vals = idf[terms] * (k1 + 1) * tf / (tf + Kd[rows])
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
        self.W = sp.csr_matrix((vals, terms, indptr), shape=(n, V))
        self.n_terms = V

    def scores(self, q):
        """Dense float64 BM25 scores of one query over every doc."""
        qv = np.zeros(self.n_terms)
        q = np.asarray(q)
        np.add.at(qv, q[q < self.n_terms], 1.0)
        return self.W @ qv

    def topk(self, query_terms, k, alpha, beta, base_rate):
        """(ids, probabilities, scores, tf) of shape (nq, k)."""
        nq = len(query_terms)
        out_ids = np.empty((nq, k), dtype=np.int64)
        out = {n: np.empty((nq, k)) for n in ("probs", "scores", "tfs")}
        indptr, indices = self.W.indptr, self.W.indices
        for qi, q in enumerate(query_terms):
            scores = self.scores(q)
            top = np.argpartition(-scores, k - 1)[:k]
            top = top[np.argsort(-scores[top], kind="stable")]
            s = scores[top]
            qset = np.unique(np.asarray(q))
            tf = np.array([np.isin(indices[indptr[d]:indptr[d + 1]],
                                   qset).sum() for d in top], dtype=float)
            r = self.dl[top] / self.avgdl
            out_ids[qi] = top
            out["probs"][qi] = reference_probability(
                s, tf, r, alpha, beta, base_rate)
            out["scores"][qi] = s
            out["tfs"][qi] = tf
        return out_ids, out["probs"], out["scores"], out["tfs"]


def bench_gpu(corpus, queries, k=10, reps=5, impact_storage="int8",
              n_runs=1):
    """Steady-state serving throughput: ``retrieve_many`` launches every
    batch's encode + kernel before pulling any result, so host work and
    transfers overlap device compute — the double-buffered regime a
    production server runs in. Values are identical to per-call
    ``retrieve`` (same kernels, same pulls; only the dispatch overlaps).

    The measured configuration is the production serving tier: int8
    (hi, lo) impact storage — the same storage the scorer auto-selects
    past 2^18 padded docs, opt-in below. Rankings are identical to the
    exact path outside exact raw-score tie groups (pinned by
    tests/test_int8_storage.py); scores carry the ~2e-4 worst-case /
    ~4e-5 mean documented error class. The constructor default (hilo
    storage) is reported beside it so the tier choice stays auditable.
    """
    rng = np.random.default_rng(7)
    from bayesian_bm25_tpu import BayesianBM25Scorer

    scorer = BayesianBM25Scorer(base_rate=0.01,
                                impact_storage=impact_storage)
    scorer.index(corpus, show_progress=False)

    # Distinct batch contents, identical encoded shapes (permutations of
    # one query pool): steady-state serving reuses compiled kernels; a
    # brand-new shape bucket would compile once and then serve warm.
    batches = [queries] + [
        [queries[i] for i in rng.permutation(len(queries))]
        for _ in range(reps - 1)
    ]
    scorer.retrieve_many(batches, k=k)  # compile + warm every shape
    runs = []
    for _ in range(n_runs):
        t0 = time.time()
        outs = scorer.retrieve_many(batches, k=k)
        dt = (time.time() - t0) / reps
        runs.append(len(queries) / dt)
    for _, probs in outs:
        assert np.all((probs >= 0) & (probs < 1))
    return runs if n_runs > 1 else runs[0]


def bench_cpu_reference(doc_terms, query_terms, k=10, reps=2):
    """Queries/s of :class:`CpuReference` on one host core."""
    ref = CpuReference(doc_terms)
    alpha, beta, base_rate = 1.0, 2.0, 0.01
    ref.topk(query_terms, k, alpha, beta, base_rate)
    t0 = time.time()
    for _ in range(reps):
        ref.topk(query_terms, k, alpha, beta, base_rate)
    dt = (time.time() - t0) / reps
    return len(query_terms) / dt


def card_name_and_power_limit() -> str:
    """``name, power.limit`` of the first GPU, read by nvidia-smi in a
    child process that does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def require_gpu():
    """The first JAX device, or exit 2 when it is not a GPU: a number
    taken on another platform must never carry a GPU metric's name."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"refusing to run: JAX's first device is {dev.platform!r} "
              f"({dev.device_kind}), not a GPU", file=sys.stderr)
        sys.exit(2)
    return dev


def _cpu_spec() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def main():
    import jax

    dev = require_gpu()
    card = card_name_and_power_limit()
    print(f"card: {card}", file=sys.stderr)

    rng = np.random.default_rng(0)
    doc_terms = corpus_term_ids(rng)
    query_terms = query_term_ids(rng)
    corpus = as_tokens(doc_terms)
    queries = as_tokens(query_terms)

    # The headline is the MEDIAN of n_runs independent timed passes
    # (each itself averaging `reps` steady-state retrieve_many calls);
    # min/max and run count ship alongside so the spread stays auditable.
    gpu_runs = sorted(bench_gpu(corpus, queries, n_runs=3))
    gpu_qps = gpu_runs[len(gpu_runs) // 2]
    # Also the ctor-default configuration (matmul_precision="high" ->
    # hilo pair storage) so the headline's serving-tier choice is
    # auditable.
    default_qps = bench_gpu(corpus, queries, impact_storage=None)
    # Baseline: median of 5 independent baseline runs (the shared host
    # core varies run to run); CPU model recorded alongside.
    cpu_runs = sorted(bench_cpu_reference(doc_terms, query_terms[:128],
                                          reps=1)
                      for _ in range(5))
    cpu_qps = cpu_runs[len(cpu_runs) // 2]

    print(json.dumps({
        "metric": "retrieval_throughput_50k_docs_top10_calibrated",
        "value": round(gpu_qps, 1),
        "unit": "queries/sec/gpu",
        "vs_baseline": round(gpu_qps / cpu_qps, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
        "serving_config": "impact_storage=int8 (rank-exact mod exact "
                          "ties; ~2e-4 worst-case score error)",
        "gpu_qps_runs": [round(x, 1) for x in gpu_runs],
        "gpu_runs_stat": {"median": round(gpu_qps, 1),
                          "min": round(gpu_runs[0], 1),
                          "max": round(gpu_runs[-1], 1),
                          "n_runs": len(gpu_runs)},
        "ctor_default_qps": round(default_qps, 1),
        "baseline_detail": {
            "cpu_qps_runs": [round(x, 1) for x in cpu_runs],
            "cpu_model": _cpu_spec(),
            "baseline_impl": "scipy-CSR BM25 + float64 numpy transform "
                             "(reference bm25s architecture), 1 core",
        },
    }))


if __name__ == "__main__":
    main()
