"""Bring-up check of the retrieval path on the GPU.

Drives the serving path a user calls — ``BayesianBM25Scorer.index`` /
``index_texts``, then ``retrieve``, ``retrieve_many`` and
``retrieve_stream`` — at two deployment sizes, and compares what comes
back with the doc-major compare path run on the same card at the highest
matmul precision, and with ``bench.py``'s float64 scipy-CSR reference on
the host:

  50k  bench.py's deployment: 50,000 docs x 150 Zipf(1.3) tokens over a
       30k vocab (seed 0), 8192-query batches of 8 tokens, k=10. Runs the
       constructor default (hilo storage) and impact_storage="int8", one
       approx=True, one coarse=True and one doc_mask call, and the score
       error of every storage tier against the highest-precision f32 path.
  1m   1,000,000 docs x 120 Zipf(1.3) tokens over a 120k vocab (seed 0),
       indexed through ``index_texts``. int8 storage engages on its own;
       the tier-2 and light/heavy merge passes must engage.

Usage (from the repository root):

    python chip_smoke.py               # both phases, one GPU
    python chip_smoke.py --devices 4   # sharded scorer on 4 GPUs only

Times printed are smoke timings of one run on the named card, not a
benchmark. Exits non-zero, and prints no result line, unless JAX's first
device is a GPU and every phase and parity check passed. The last line of
stdout is then one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass

import numpy as np

import bench

# Tolerances, each with the documented class it enforces.
TOL_HILO = 1e-5   # hilo bf16 pair storage: ~8e-6 relative score error
# int8 pair storage is gated against its representation bound (see
# score_bound); its relative error is reported.
TOL_PROB = 1e-5   # f32 Bayesian transform vs float64, absolute
EPS_F32 = 1e-6    # the package's float32 probability clamp


@dataclass
class PhaseSize:
    n_docs: int
    doc_len: int
    vocab: int
    n_queries: int       # queries per batch
    qlen: int = 8
    k: int = 10
    n_host_check: int = 256  # queries also checked against the host


SIZE_50K = PhaseSize(n_docs=50_000, doc_len=150, vocab=30_000,
                     n_queries=8192, n_host_check=256)
SIZE_1M = PhaseSize(n_docs=1_000_000, doc_len=120, vocab=120_000,
                    n_queries=8192, n_host_check=64)


class Checks:
    """Collects named parity results; a failed gate fails the run."""

    def __init__(self):
        self.failed: list[str] = []

    def gate(self, name: str, value: float, tol: float) -> None:
        ok = bool(np.isfinite(value)) and value <= tol
        print(f"  {'PASS' if ok else 'FAIL'} {name}: {value:.3e} "
              f"(tolerance {tol:.0e})")
        if not ok:
            self.failed.append(name)

    def require(self, name: str, ok: bool, detail: str = "") -> None:
        print(f"  {'PASS' if ok else 'FAIL'} {name}{': ' if detail else ''}"
              f"{detail}")
        if not ok:
            self.failed.append(name)

    @staticmethod
    def info(name: str, value) -> None:
        print(f"  info {name}: {value}")


# ---------------------------------------------------------------------------
# References
# ---------------------------------------------------------------------------


def device_reference(scorer, queries, k, doc_mask=None):
    """The plain reference on the scorer's device: the doc-major compare
    path (no split, no merge, no selection prefilter) at the highest
    matmul precision. Returns host arrays (ids, probs, scores, tfs) of
    shape (nq, k) and the device (nq, D_pad) score and tf matrices."""
    import jax
    import jax.numpy as jnp

    from bayesian_bm25_tpu.engine import scoring

    idx, t = scorer.bm25_index, scorer.transform
    qids, qcnt = scorer._encode(queries)
    mask = None if doc_mask is None else jnp.asarray(doc_mask)
    with jax.default_matmul_precision("highest"):
        ids, probs, scores, tfs = scoring.retrieve_topk(
            idx.term_ids, idx.weights, idx.doc_lengths, idx.avgdl,
            qids, qcnt, k, t.alpha, t.beta, t.base_rate,
            n_docs=idx.n_docs,
            prior_free=t._training_mode == "prior_free", doc_mask=mask)
        full_s, full_tf = scoring.score_all(idx.term_ids, idx.weights,
                                            qids, qcnt)
    return ((np.asarray(ids), np.asarray(probs), np.asarray(scores),
             np.asarray(tfs)), full_s, full_tf)


def launch(scorer, queries, k, **kw):
    """The serving kernel as ``retrieve`` runs it, with its scores and
    tfs: host (ids, probs, scores, tfs), each (nq, k)."""
    nq, ids, probs, scores, tfs = scorer._retrieve_launch(
        queries, k, kw.get("approx", False), kw.get("doc_mask"),
        coarse=kw.get("coarse", False))
    return tuple(np.asarray(a)[:nq] for a in (ids, probs, scores, tfs))


def _take(full, ids):
    """full[q, ids[q, r]] on the device, pulled to the host."""
    import jax.numpy as jnp

    return np.asarray(jnp.take_along_axis(
        full, jnp.asarray(np.maximum(ids, 0)), axis=1))


def score_bound(scorer, queries, ids, ref_vals):
    """The score error the scorer's storage tier allows at doc ids[q, r]
    (reference score ref_vals[q, r]), as an absolute bound.

    hilo: TOL_HILO relative. int8: the representation's own bound —
    each stored element is within s2_d / 2 of the f32 impact (s2_d the
    doc's residual scale, about amax_d / 64500), so a score is within
    (sum of the query's frequent-term counts) * s2_d / 2, plus f32
    rounding of the dequantization (1e-6 of the doc's max impact per
    term)."""
    from bayesian_bm25_tpu.engine import split_index as sidx

    s = scorer._split
    if s.impact_scale is None:
        return TOL_HILO * np.abs(ref_vals)
    fcnt = sidx.encode_queries_split(queries, s)[1][:len(queries)]
    qsum = fcnt.sum(axis=1)[:, None]
    scale = np.asarray(s.impact_scale, dtype=np.float64)[:, np.maximum(
        ids, 0)]
    return qsum * (scale[1] / 2 + 1e-6 * 127 * scale[0]) + \
        1e-6 * np.abs(ref_vals)


def gate_scores(checks, label, scorer, queries, ids, got_s, ref_at):
    """Gate the returned scores against the reference at the same docs."""
    pos = (ids >= 0) & (ref_at > 0)
    rel = np.abs(got_s[pos] - ref_at[pos]) / ref_at[pos] if pos.any() \
        else np.zeros(1)
    if scorer._split.impact_scale is None:
        checks.gate(f"{label} score relative error (max)",
                    float(rel.max()), TOL_HILO)
    else:
        bound = score_bound(scorer, queries, ids, ref_at)
        ratio = np.abs(got_s - ref_at)[pos] / bound[pos]
        checks.gate(f"{label} score error / int8 representation bound "
                    "(max)", float(ratio.max(initial=0.0)), 1.0)
        checks.info(f"{label} score relative error (max; the 3e-4 "
                    "figure quoted for int8)", f"{rel.max():.3e}")
    checks.info(f"{label} score relative error (mean)", f"{rel.mean():.3e}")


def id_mismatches(scorer, queries, ids, ref_ids, ref_at, ref_scores):
    """Counts of rank positions whose id differs from the reference:
    inside exact raw-score ties, inside ties within the storage tier's
    error bound, and outside both (a ranking error)."""
    diff = (ids != ref_ids) & (ref_ids >= 0)
    gap = np.abs(ref_at - ref_scores)
    allowed = (score_bound(scorer, queries, ids, ref_at)
               + score_bound(scorer, queries, ref_ids, ref_scores))
    return (int((diff & (gap == 0)).sum()),
            int((diff & (gap > 0) & (gap <= allowed)).sum()),
            int((diff & (gap > allowed)).sum()))


def compare(checks, label, got, ref, ref_full_s, ref_full_tf, scorer,
            queries):
    """Gate one kernel result against the device reference.

    ids: equal wherever the reference does not tie the two docs within
    the storage tier's error bound (exact-tie and bound-tie mismatches
    are counted separately); scores: error at the returned docs; tf:
    exact; probabilities: the f32 transform of the returned (score, tf,
    length) against the float64 transform of the same inputs."""
    ids, probs, scores, tfs = got
    r_ids, r_probs, r_scores, _ = ref
    valid = ids >= 0
    ref_at = _take(ref_full_s, ids).astype(np.float64)
    tf_at = _take(ref_full_tf, ids)
    checks.require(f"{label} ids filled like the reference",
                   bool(np.array_equal(valid, r_ids >= 0)))
    n_tie, n_near, n_bad = id_mismatches(
        scorer, queries, ids, r_ids, ref_at, r_scores.astype(np.float64))
    checks.info(f"{label} ids differing inside exact raw-score ties", n_tie)
    checks.info(f"{label} ids differing inside ties within the storage "
                "bound", n_near)
    checks.require(f"{label} ids equal outside tie groups", n_bad == 0,
                   f"{n_bad} of {ids.size} differ")
    gate_scores(checks, label, scorer, queries, ids, scores, ref_at)
    checks.require(f"{label} tf exact", bool(np.array_equal(
        tfs[valid], tf_at[valid])))
    transform_parity(checks, label, got, scorer)
    same = (ids == r_ids) & valid
    if same.any():
        checks.info(f"{label} probability vs reference (max abs, "
                    f"same ids)", f"{np.abs(probs - r_probs)[same].max():.3e}")


def transform_parity(checks, label, got, scorer):
    ids, probs, scores, tfs = got
    valid = ids >= 0
    idx, t = scorer.bm25_index, scorer.transform
    dl = np.asarray(idx.doc_lengths, dtype=np.float64)[np.maximum(ids, 0)]
    p64 = bench.reference_probability(
        scores.astype(np.float64), tfs.astype(np.float64), dl / idx.avgdl,
        t.alpha, t.beta, t.base_rate, eps=EPS_F32)
    checks.require(f"{label} probabilities finite in [0, 1)", bool(
        np.all(np.isfinite(probs)) and np.all((probs >= 0) & (probs < 1))))
    err = np.abs(probs - p64)[valid].max() if valid.any() else 0.0
    checks.gate(f"{label} f32 transform vs float64 (max abs)", float(err),
                TOL_PROB)


def compare_host(checks, label, got, host_ref, query_terms, scorer):
    """Gate a result subset against the float64 scipy-CSR reference."""
    ids, probs, scores, _ = got
    t = scorer.transform
    queries = bench.as_tokens(query_terms)
    h_ids, h_probs, h_scores, _ = host_ref.topk(
        query_terms, ids.shape[1], t.alpha, t.beta, t.base_rate)
    at = np.stack([host_ref.scores(q)[np.maximum(row, 0)]
                   for q, row in zip(query_terms, ids)])
    _, _, n_bad = id_mismatches(scorer, queries, ids, h_ids, at, h_scores)
    checks.require(f"{label} ids vs float64 host reference outside ties",
                   n_bad == 0, f"{n_bad} of {ids.size} differ "
                   f"({len(query_terms)} queries)")
    gate_scores(checks, f"{label} vs float64 host", scorer, queries, ids,
                scores, at)
    same = ids == h_ids
    checks.info(f"{label} probability vs float64 host (max abs, same ids)",
                f"{np.abs(probs - h_probs)[same].max(initial=0.0):.3e}")


# ---------------------------------------------------------------------------
# Timing and reporting helpers
# ---------------------------------------------------------------------------


def memory_line(label):
    import jax

    for d in jax.local_devices():
        st = d.memory_stats() or {}
        print(f"  memory {label} {d}: bytes_in_use="
              f"{st.get('bytes_in_use', 'n/a')} peak_bytes_in_use="
              f"{st.get('peak_bytes_in_use', 'n/a')}")


class PassSpy:
    """Records which merge passes each sparse-kernel launch engaged.

    Wraps ``split_index.retrieve_topk_split_sparse`` (the scorer looks it
    up at call time) without changing what it computes."""

    def __init__(self):
        from bayesian_bm25_tpu.engine import split_index as sidx

        self.sidx = sidx
        self.orig = sidx.retrieve_topk_split_sparse
        self.seen: list[dict] = []

    def __enter__(self):
        def spy(*args, **kw):
            self.seen.append({
                "tier1": True,
                "light_heavy": kw.get("tailH_rows") is not None,
                "tier2": kw.get("tailB_rows") is not None,
                "tier2_light_heavy": kw.get("tailB2_rows") is not None,
                "packed": kw.get("compact") is not None,
                "cand_cap": args[12],
            })
            return self.orig(*args, **kw)

        self.sidx.retrieve_topk_split_sparse = spy
        return self

    def __exit__(self, *exc):
        self.sidx.retrieve_topk_split_sparse = self.orig

    def summary(self):
        keys = ("tier1", "light_heavy", "tier2", "tier2_light_heavy",
                "packed")
        return {k: sum(s[k] for s in self.seen) for k in keys} | {
            "launches": len(self.seen),
            "cand_caps": sorted({s["cand_cap"] for s in self.seen})}


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def serve_and_time(checks, label, scorer, batches, k, card):
    """Compile (set-up: a first retrieve, then every batch once so each
    shape bucket is warm), then time steady batches through all three
    serving entry points, each ending in host arrays (which waits for
    the device). Returns the first batch's (ids, probs)."""
    first, t_compile = timed(lambda: scorer.retrieve(batches[0], k=k))
    _, t_warm = timed(lambda: scorer.retrieve_many(batches, k=k))
    print(f"  {label} set-up: first retrieve (compile + run) "
          f"{t_compile:.3f} s; warm-up over all batches {t_warm:.3f} s")
    one, t_one = timed(lambda: scorer.retrieve(batches[0], k=k))
    many, t_many = timed(lambda: scorer.retrieve_many(batches, k=k))
    stream, t_stream = timed(
        lambda: list(scorer.retrieve_stream(batches, k=k)))
    nq = len(batches[0])
    print(f"  {label} smoke timings on {card} (one run, not a benchmark): "
          f"retrieve {t_one * 1e3:.2f} ms/batch; retrieve_many "
          f"{t_many / len(batches) * 1e3:.2f} ms/batch; retrieve_stream "
          f"{t_stream / len(batches) * 1e3:.2f} ms/batch "
          f"({len(batches)} batches of {nq} queries)")
    same = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
               for a, b in zip(many, stream))
    same &= np.array_equal(one[0], many[0][0]) and np.array_equal(
        one[1], many[0][1]) and np.array_equal(first[0], one[0])
    checks.require(f"{label} retrieve / retrieve_many / retrieve_stream "
                   "agree", bool(same))
    return one


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def storage_error_classes(checks, scorer, queries):
    """Score error of every storage tier and matmul precision class
    against f32 storage at HIGHEST, on the split path's dense scores."""
    import jax

    from bayesian_bm25_tpu.engine import split_index as sidx

    idx = scorer.bm25_index
    K = scorer._split.n_frequent
    P = jax.lax.Precision
    base = sidx.build_split_index(idx, n_frequent=K, storage="f32")
    enc = sidx.encode_queries_split(queries, base)
    ref = np.asarray(sidx.score_all_split(base, *enc,
                                          precision=P.HIGHEST)[0])
    m = ref > 1e-3
    rows = [("f32 highest", base, P.HIGHEST), ("f32 high", base, P.HIGH),
            ("f32 default", base, P.DEFAULT)]
    for storage in ("hilo", "bf16", "int8"):
        rows.append((storage, sidx.build_split_index(
            idx, n_frequent=K, storage=storage), P.DEFAULT))
    out = {}
    for name, split, prec in rows:
        s = np.asarray(sidx.score_all_split(split, *enc,
                                            precision=prec)[0])
        rel = np.abs(s[m] - ref[m]) / ref[m]
        out[name] = (float(rel.max()), float(rel.mean()))
        checks.info(f"storage class {name}", f"max rel {rel.max():.3e}, "
                    f"mean rel {rel.mean():.3e} ({int(m.sum())} scores)")
    checks.gate("storage class hilo (max rel)", out["hilo"][0], TOL_HILO)
    checks.gate("storage class f32 high (max rel)", out["f32 high"][0],
                TOL_HILO)
    return out


def phase_50k(checks, card, size=SIZE_50K, n_batches=3):
    import gc

    from bayesian_bm25_tpu import BayesianBM25Scorer

    print(f"phase 50k: {size}")
    rng = np.random.default_rng(0)
    doc_terms = bench.corpus_term_ids(rng, size.n_docs, size.doc_len,
                                      size.vocab)
    query_terms = bench.query_term_ids(rng, size.n_queries, size.qlen,
                                       size.vocab)
    corpus = bench.as_tokens(doc_terms)
    queries = bench.as_tokens(query_terms)
    perm = np.random.default_rng(7)
    batches = [queries] + [[queries[i] for i in perm.permutation(
        len(queries))] for _ in range(n_batches - 1)]
    host_ref, t_ref = timed(lambda: bench.CpuReference(doc_terms))
    print(f"  host reference built in {t_ref:.1f} s")
    sub = slice(0, size.n_host_check)
    k = size.k

    for storage in (None, "int8"):
        label = f"50k/{storage or 'hilo (ctor default)'}"
        scorer = BayesianBM25Scorer(base_rate=0.01, impact_storage=storage)
        _, t_build = timed(lambda: scorer.index(corpus,
                                                show_progress=False))
        s = scorer._split
        print(f"  {label}: index {t_build:.1f} s (host build + device "
              f"placement); K={s.n_frequent}, storage="
              f"{'int8' if s.impact_scale is not None else 'hilo' if s.dense_impact_lo is not None else s.dense_impact.dtype}")
        with PassSpy() as spy:
            serve_and_time(checks, label, scorer, batches, k, card)
        checks.info(f"{label} merge passes", spy.summary())
        got = launch(scorer, queries, k)
        ref, full_s, full_tf = device_reference(scorer, queries, k)
        compare(checks, label, got, ref, full_s, full_tf, scorer, queries)
        compare_host(checks, label, tuple(a[sub] for a in got), host_ref,
                     query_terms[sub], scorer)
        if storage is None:
            # The compare path itself against the float64 host reference.
            compare_host(checks, "50k/device compare path",
                         tuple(a[sub] for a in ref), host_ref,
                         query_terms[sub], scorer)
            approx = launch(scorer, queries, k, approx=True)
            transform_parity(checks, f"{label} approx", approx, scorer)
            overlap = np.mean([len(set(a) & set(b)) / k
                               for a, b in zip(approx[0], ref[0])])
            checks.info(f"{label} approx top-{k} recall vs exact",
                        f"{overlap:.4f}")
            mask = np.random.default_rng(3).random(size.n_docs) < 0.5
            got_m = launch(scorer, queries, k, doc_mask=mask)
            checks.require(f"{label} doc_mask excludes masked docs",
                           bool(np.all(mask[got_m[0][got_m[0] >= 0]])))
            ref_m, fs_m, ft_m = device_reference(scorer, queries, k,
                                                 doc_mask=mask)
            compare(checks, f"{label} doc_mask", got_m, ref_m, fs_m, ft_m,
                    scorer, queries)
            public_m = scorer.retrieve(queries, k=k, doc_mask=mask)
            checks.require(f"{label} doc_mask retrieve == kernel", bool(
                np.array_equal(public_m[0], got_m[0])))
            storage_error_classes(checks, scorer, queries[:512])
        else:
            coarse = launch(scorer, queries, k, coarse=True)
            overlap = np.mean([len(set(a) & set(b)) / k
                               for a, b in zip(coarse[0], ref[0])])
            at = _take(full_s, coarse[0])
            pos = (coarse[0] >= 0) & (at > 0)
            rel = np.abs(coarse[2][pos] - at[pos]) / at[pos]
            checks.info(f"{label} coarse top-{k} overlap with exact "
                        "(reported, not gated: rank-only tier)",
                        f"{overlap:.4f}")
            checks.info(f"{label} coarse score relative error",
                        f"max {rel.max():.3e}, mean {rel.mean():.3e}")
            transform_parity(checks, f"{label} coarse", coarse, scorer)
            public_c = scorer.retrieve(queries, k=k, coarse=True)
            checks.require(f"{label} coarse retrieve == kernel", bool(
                np.array_equal(public_c[0], coarse[0])))
        del scorer, full_s, full_tf
        gc.collect()
    memory_line("after phase 50k")


def texts_of(doc_terms):
    """One whitespace-joined text per doc ("t<id> t<id> ..."): the input
    ``index_texts`` takes, built without a list of per-token strings."""
    vt = np.array([f"t{i}" for i in range(int(doc_terms.max()) + 1)],
                  dtype=object)
    return [" ".join(vt[row]) for row in doc_terms]


def index_1m(scorer, size=SIZE_1M):
    """Generate the phase-1m corpus and index it through index_texts.
    Returns (doc_terms, query_terms, texts)."""
    rng = np.random.default_rng(0)
    doc_terms = bench.corpus_term_ids(rng, size.n_docs, size.doc_len,
                                      size.vocab)
    query_terms = bench.query_term_ids(rng, size.n_queries, size.qlen,
                                       size.vocab)
    texts, t_texts = timed(lambda: texts_of(doc_terms))
    _, t_build = timed(lambda: scorer.index_texts(
        texts, lowercase=True, remove_stopwords=False, stem=False))
    print(f"  corpus texts generated in {t_texts:.1f} s; host build "
          f"(index_texts: tokenize, index, split, calibrate) "
          f"{t_build:.1f} s")
    return doc_terms, query_terms, texts


def phase_1m(checks, card, size=SIZE_1M, n_batches=2):
    import gc

    from bayesian_bm25_tpu import BayesianBM25Scorer

    print(f"phase 1m: {size}")
    scorer = BayesianBM25Scorer(base_rate=0.01)
    doc_terms, query_terms, texts = index_1m(scorer, size)
    del texts
    queries = bench.as_tokens(query_terms)
    s = scorer._split
    print(f"  split: K={s.n_frequent}, int8 storage="
          f"{s.impact_scale is not None}, tier-1 postings "
          f"{None if s.post_doc_ids is None else tuple(s.post_doc_ids.shape)}"
          ", tier-2 postings "
          f"{None if s.post2_doc_ids is None else tuple(s.post2_doc_ids.shape)}"
          f", query chunk {scorer._auto_batch_size()}")
    checks.require("1m int8 storage chosen automatically",
                   s.impact_scale is not None)
    perm = np.random.default_rng(7)
    batches = [queries] + [[queries[i] for i in perm.permutation(
        len(queries))] for _ in range(n_batches - 1)]
    k = size.k
    with PassSpy() as spy:
        serve_and_time(checks, "1m/int8", scorer, batches, k, card)
    passes = spy.summary()
    checks.info("1m merge passes engaged (launch counts)", passes)
    checks.require("1m tier-2 pass engaged", passes["tier2"] > 0)
    checks.require("1m light/heavy pass engaged",
                   passes["light_heavy"] + passes["tier2_light_heavy"] > 0)
    # Parity on one auto-sized chunk: its (nq, D) reference matrices fit
    # beside the index.
    chunk = scorer._auto_batch_size()
    got = launch(scorer, queries[:chunk], k)
    ref, full_s, full_tf = device_reference(scorer, queries[:chunk], k)
    compare(checks, "1m/int8", got, ref, full_s, full_tf, scorer,
            queries[:chunk])
    del full_s, full_tf
    gc.collect()
    host_ref, t_ref = timed(lambda: bench.CpuReference(doc_terms))
    print(f"  host reference built in {t_ref:.1f} s")
    sub = slice(0, size.n_host_check)
    compare_host(checks, "1m/int8", tuple(a[sub] for a in got), host_ref,
                 query_terms[sub], scorer)
    memory_line("after phase 1m")


def sharded_phase(checks, devices, size=SIZE_1M, n_queries=1024):
    """ShardedBayesianBM25Scorer on a len(devices)-way document mesh and
    on a (2, n/2) query x document mesh, against the single-device
    scorer on devices[0], over the same corpus and queries."""
    import jax
    from jax.sharding import Mesh

    from bayesian_bm25_tpu import (BayesianBM25Scorer,
                                   ShardedBayesianBM25Scorer)

    n = len(devices)
    print(f"sharded phase: {n} devices, {size}")
    with jax.default_device(devices[0]):
        single = BayesianBM25Scorer(base_rate=0.01)
        _, query_terms, texts = index_1m(single, size)
        queries = bench.as_tokens(query_terms[:n_queries])
        k = size.k
        s_ids, s_probs = single.retrieve(queries, k=k)
        _, full_s, _ = device_reference(single, queries, k)
        s_at = _take(full_s, s_ids)
    memory_line("after the single-device index")
    meshes = [("1-D doc mesh", Mesh(np.array(devices), ("d",)))]
    if n % 2 == 0 and n >= 4:
        meshes.append((f"(2, {n // 2}) query x doc mesh",
                       Mesh(np.array(devices).reshape(2, n // 2),
                            ("q", "d"))))
    for name, mesh in meshes:
        sh = ShardedBayesianBM25Scorer(base_rate=0.01, mesh=mesh)
        _, t_build = timed(lambda: sh.index_texts(
            texts, lowercase=True, remove_stopwords=False, stem=False))
        print(f"  {name}: host build {t_build:.1f} s")
        memory_line(f"after indexing ({name})")
        (ids, probs), t_first = timed(lambda: sh.retrieve(queries, k=k))
        _, t_again = timed(lambda: sh.retrieve(queries, k=k))
        print(f"  {name}: first retrieve {t_first:.3f} s, again "
              f"{t_again * 1e3:.2f} ms ({len(queries)} queries; smoke "
              "timing, not a benchmark)")
        diff = ids != s_ids
        # a differing id is fine only inside an exact tie group of the
        # compare path's scores
        with jax.default_device(devices[0]):
            tie = _take(full_s, ids) == s_at
        n_bad = int((diff & ~tie).sum())
        checks.require(f"sharded {name} ids equal the single device "
                       "outside exact ties", n_bad == 0,
                       f"{n_bad} of {ids.size} differ")
        same = ~diff
        checks.gate(f"sharded {name} probabilities vs single device "
                    "(max abs, same ids)",
                    float(np.abs(probs - s_probs)[same].max(initial=0.0)),
                    TOL_PROB)
        del sh


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def native_encoder_line() -> str:
    from bayesian_bm25_tpu.engine import native

    try:
        native._load()
    except (ImportError, OSError) as exc:
        return f"numpy fallback ({str(exc).splitlines()[0][:120]})"
    return f"built ({native.library_path()})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=0,
                    help="run only the sharded scorer on this many GPUs "
                         "and its single-device comparison")
    args = ap.parse_args(argv)

    import jax

    dev = bench.require_gpu()
    card = bench.card_name_and_power_limit()
    print(f"card (nvidia-smi name, power.limit): {card}")
    print(f"jax {jax.__version__}, jaxlib "
          f"{__import__('jaxlib').__version__}; devices: "
          f"{len(jax.devices())} x {dev.device_kind}")
    print(f"native encoder: {native_encoder_line()}")
    checks = Checks()
    t0 = time.perf_counter()
    if args.devices:
        devices = jax.devices()
        if len(devices) < args.devices:
            raise SystemExit(f"--devices {args.devices}: only "
                             f"{len(devices)} devices")
        sharded_phase(checks, devices[:args.devices])
        count = args.devices
    else:
        phase_50k(checks, card)
        phase_1m(checks, card)
        count = len(jax.devices())
    print(f"total wall time {time.perf_counter() - t0:.1f} s")
    if checks.failed:
        print("FAILED: " + "; ".join(checks.failed), file=sys.stderr)
        return 1
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
