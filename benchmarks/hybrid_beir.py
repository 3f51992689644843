"""Hybrid sparse+dense retrieval benchmark — the flagship integration path.

Reproduces the reference's hybrid_beir harness (benchmarks/hybrid_beir.py):
35+ fusion methods over BEIR-format datasets, with the protocol
retrieve top-R per signal -> fuse the union -> evaluate top-k
(hybrid_beir.py:1702-2331). Restructured for the device: BM25 scoring for
the whole query set is one batched device call; dense scoring is one
matmul; only the per-query union fusion stays host-side.

Environment note: with no dataset/model egress, --synthetic (default) runs
a self-contained topical dataset and the hash encoder; --data-dir loads
BEIR-format directories and uses sentence-transformers when its weights
are cached.

Usage:
  python benchmarks/hybrid_beir.py                      # synthetic
  python benchmarks/hybrid_beir.py --data-dir path/scifact --tune -o out.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")

from bayesian_bm25_tpu import (  # noqa: E402
    AttentionLogOddsWeights,
    BayesianBM25Scorer,
    MultiFieldScorer,
    MultiHeadAttentionLogOddsWeights,
    PlattCalibrator,
    VectorProbabilityTransform,
    balanced_log_odds_fusion,
    cosine_to_probability,
    ivf_density_prior,
    log_odds_conjunction,
    prob_or,
)
from bayesian_bm25_tpu.engine.ivf import SimpleIVF  # noqa: E402
from bayesian_bm25_tpu.utils.diagnostics import (  # noqa: E402
    build_exact_search_diagnostics,
    build_ivf_search_diagnostics,
    separability_gate,
)
from bayesian_bm25_tpu.engine.tokenize import tokenize_texts  # noqa: E402
from bayesian_bm25_tpu.models.probability import (  # noqa: E402
    BayesianProbabilityTransform,
)
from benchmarks.metrics import evaluate_run  # noqa: E402
from benchmarks.utils import (  # noqa: E402
    IRDataset,
    encode_dense,
    load_beir_dataset,
    synthetic_dataset,
)

RRF_K = 60

# Probability-producing methods whose fused values are calibration
# diagnostics candidates (mirrors the reference's CALIBRATION_METHODS,
# hybrid_beir.py:2480-2505 — raw-score fusions like BM25/Convex/RRF are
# excluded; Balanced is included deliberately: its min-max fusion SCORE
# is in [0,1] but is NOT a calibrated probability, and its poor ECE
# next to LogOdds' is part of the published story).
CALIBRATION_METHODS = [
    "Bayesian-OR", "Bayesian-LogOdds", "Bayesian-LogOdds-Local",
    "Bayesian-LogOdds-BR",
    "Bayesian-Balanced", "Bayesian-Balanced-Mix", "Bayesian-Balanced-Elbow",
    "Bayesian-Gated-ReLU", "Bayesian-Gated-Swish", "Bayesian-Gated-GELU",
    "Bayesian-Gated-Swish-B2", "Bayesian-Gated-Softplus",
    "Bayesian-Attention", "Bayesian-Attn-Norm", "Bayesian-Attn-Norm-CV",
    "Bayesian-MultiHead", "Bayesian-MultiHead-Norm",
    "Bayesian-MultiField", "Bayesian-MultiField-Bal",
    "Bayesian-Vector-Balanced", "Bayesian-Vector-Softplus",
    "Bayesian-Vector-Attn",
    "VPT-DensityPrior", "VPT-BM25Weights",
    "VPT-BW-0.2", "VPT-BW-0.5", "VPT-BW-1.0", "VPT-BW-2.0",
    "Dense-Kappa", "Dense-Platt",
]


def _minmax(x: np.ndarray) -> np.ndarray:
    lo, hi = float(np.min(x)), float(np.max(x))
    if hi - lo < 1e-12:
        return np.zeros_like(x)
    return (x - lo) / (hi - lo)


def _rank_of(scores: np.ndarray) -> np.ndarray:
    order = np.argsort(-scores)
    ranks = np.empty_like(order)
    ranks[order] = np.arange(len(scores))
    return ranks


def _logit_clip(p: np.ndarray, max_logit: float) -> np.ndarray:
    p = np.clip(np.asarray(p, dtype=np.float64), 1e-10, 1 - 1e-10)
    return np.clip(np.log(p / (1 - p)), -max_logit, max_logit)


def _fusion_vpt_balanced(sparse_probs, vpt_dense_probs,
                         max_logit: float = 12.0) -> np.ndarray:
    """Additive log-odds fusion of lexical evidence with VPT-calibrated
    dense evidence, the reference's VPT-method fusion
    (hybrid_beir.py:812-842): clipped logits, dense arm scaled down to
    the sparse arm's logit spread when wider, summed, re-sigmoided."""
    ls = _logit_clip(sparse_probs, max_logit)
    ld = _logit_clip(vpt_dense_probs, max_logit)
    s_std = max(float(np.std(ls)), 1e-6)
    d_std = max(float(np.std(ld)), 1e-6)
    fused = ls + min(1.0, s_std / d_std) * ld
    return 1.0 / (1.0 + np.exp(-np.clip(fused, -max_logit, max_logit)))


def _vpt_sample_guidance(lex_probs, lex_active, density_prior=None,
                         *, neutral: float = 0.5, floor: float = 0.5,
                         max_logit: float = 10.0) -> np.ndarray:
    """Blended VPT sample guidance (reference hybrid_beir.py:478-530):
    missing lexical evidence is neutral (0.5), active evidence is
    floored at 0.5, and an IVF density prior (when present) blends in
    logit space with a lexical mix growing with the active ratio."""
    lex_probs = np.asarray(lex_probs, dtype=np.float64)
    lex_active = np.asarray(lex_active, dtype=bool)
    guidance = np.full(len(lex_probs), neutral, dtype=np.float64)
    if lex_active.any():
        guidance[lex_active] = np.maximum(lex_probs[lex_active], floor)
    if density_prior is None:
        return guidance
    active_ratio = float(np.mean(lex_active)) if len(guidance) else 0.0
    mix = float(np.clip(0.35 + 0.5 * active_ratio, 0.35, 0.85))
    blended = (mix * _logit_clip(guidance, max_logit)
               + (1.0 - mix) * _logit_clip(density_prior, max_logit))
    return 1.0 / (1.0 + np.exp(-np.clip(blended, -max_logit, max_logit)))


def _query_features_basic(q_tokens, bm25_union_scores):
    hits = float(np.mean(bm25_union_scores > 0)) if len(bm25_union_scores) else 0.0
    mx = float(np.max(bm25_union_scores)) if len(bm25_union_scores) else 0.0
    return np.array([np.log1p(len(q_tokens)), hits, np.log1p(mx)])


def _query_features_rich(basic, dense_union, bm25_top100, dense_top100):
    top10 = np.sort(dense_union)[::-1][:10]
    extra = np.array([
        float(np.mean(top10)) if len(top10) else 0.0,
        float(np.std(top10)) if len(top10) else 0.0,
        np.log1p(float(np.max(dense_union)) if len(dense_union) else 0.0),
        len(set(bm25_top100) & set(dense_top100))
        / max(len(set(bm25_top100) | set(dense_top100)), 1),
    ])
    return np.concatenate([basic, extra])


def run_dataset(
    ds: IRDataset,
    *,
    k: int = 10,
    R: int = 1000,
    dense_backend: str = "auto",
    use_ivf: bool = False,
    ivf_cells: int | None = None,
    ivf_nprobe: int | None = None,
    ivf_iterations: int = 10,
    ivf_seed: int = 42,
    vpt_query_gating: bool = False,
    tune: bool = False,
    seed: int = 42,
    verbose: bool = True,
    methods: list[str] | None = None,
    attn_iters: int = 2000,
) -> dict:
    """Run every hybrid method on one dataset; returns {method: metrics}.

    ``methods``: optional list of substrings — only methods whose name
    contains one of them are computed (and the expensive stages that
    feed ONLY unwanted methods are skipped entirely). Used by the
    multi-seed ordering studies, where running all 38 methods per seed
    would be wasteful.
    """
    t0 = time.time()
    rng = np.random.default_rng(seed)

    def want(name: str) -> bool:
        # Symmetric containment: a gate name matches when a filter is a
        # substring of it (add-site full names vs short filters like
        # "Balanced") OR it is a substring of a filter (family gates
        # like want("Attn") / want("VPT") vs full-name filters like
        # "Bayesian-Attn-Norm"). Asymmetric matching silently skipped
        # the attention-training / VPT-fit stages when callers filtered
        # by full method names. Over-inclusion (e.g. "BM25" matching a
        # "VPT-BM25Weights" filter) only computes a cheap extra method.
        return methods is None or any(
            m in name or name in m for m in methods)

    def want_family(prefix: str) -> bool:
        # Kept for call-site clarity: gates shared computation that
        # several full method names consume; equivalent to the
        # name-in-filter half of `want`.
        return methods is None or any(prefix in m for m in methods)

    def log(msg):
        if verbose:
            print(f"[{time.time()-t0:6.1f}s] {msg}", flush=True)

    doc_ids = ds.doc_ids
    doc_pos = {d: i for i, d in enumerate(doc_ids)}
    doc_texts = [ds.corpus[d] for d in doc_ids]
    # Snowball (Porter2) matches the reference harness's bm25s +
    # SnowballStemmer('english') tokenization (hybrid_beir.py:288-296).
    corpus_tokens = tokenize_texts(doc_texts, stem="snowball")
    qids_list = list(ds.queries.keys())
    query_tokens = tokenize_texts([ds.queries[q] for q in qids_list],
                                  stem="snowball")
    log(f"tokenized {len(doc_ids)} docs / {len(qids_list)} queries")

    # --- index four BM25 scorers (plain + three auto base-rate modes) ------
    scorers = {}
    for key, br, brm in (
        ("plain", None, "percentile"),
        ("auto", "auto", "percentile"),
        ("mixture", "auto", "mixture"),
        ("elbow", "auto", "elbow"),
    ):
        if key == "mixture" and not want("Balanced-Mix"):
            continue
        if key == "elbow" and not want("Balanced-Elbow"):
            continue
        s = BayesianBM25Scorer(method="lucene", base_rate=br,
                               base_rate_method=brm)
        s.index(corpus_tokens, show_progress=False)
        scorers[key] = s
    bm25 = scorers["plain"]
    log(f"indexed scorers (auto base_rate={scorers['auto'].base_rate:.2e})")

    # --- multi-field -------------------------------------------------------
    mf = None
    mf_bal_weight = 0.5
    if ds.titles:
        title_tokens = tokenize_texts(
            [ds.titles.get(d, "") for d in doc_ids], stem="snowball"
        )
        mf = MultiFieldScorer(["title", "body"], base_rate="auto")
        mf.index(
            [{"title": t, "body": b}
             for t, b in zip(title_tokens, corpus_tokens)],
            show_progress=False,
        )
        log("multi-field indexed")

    # --- dense encodings + full score matrices -----------------------------
    if ds.doc_emb is not None and dense_backend == "auto":
        corpus_emb = ds.doc_emb
        query_emb = ds.query_emb
    else:
        corpus_emb = encode_dense(doc_texts, backend=dense_backend)
        query_emb = encode_dense([ds.queries[q] for q in qids_list],
                                 backend=dense_backend)
    corpus_emb = corpus_emb / np.maximum(
        np.linalg.norm(corpus_emb, axis=1, keepdims=True), 1e-9)
    query_emb = query_emb / np.maximum(
        np.linalg.norm(query_emb, axis=1, keepdims=True), 1e-9)

    import jax.numpy as jnp

    dense_all = np.asarray(jnp.asarray(query_emb) @ jnp.asarray(corpus_emb).T)
    bm25_all = bm25.get_scores_batch(query_tokens)
    log("scored all queries (dense matmul + batched BM25)")

    probs_all = {
        key: scorers[key].get_probabilities_batch(query_tokens)
        for key in scorers
    }
    log("bayesian probability arrays computed")

    mf_probs_all = None
    if mf is not None:
        mf_probs_all = mf.get_probabilities_batch(query_tokens)
        log("multi-field probabilities (batched)")

    ivf = None
    if use_ivf:
        ivf = SimpleIVF.build(corpus_emb, n_cells=ivf_cells,
                              max_iterations=ivf_iterations, seed=ivf_seed)
        log(f"ivf built: {ivf.n_cells} cells "
            f"(nprobe={ivf_nprobe or ivf.default_nprobe})")

    # --- global kappa background (50 queries x up to 1000 docs) ------------
    bg_rows = rng.choice(len(qids_list), size=min(50, len(qids_list)),
                         replace=False)
    bg_sample = dense_all[bg_rows][:, rng.choice(
        len(doc_ids), size=min(1000, len(doc_ids)), replace=False)]
    kappa_mu = float(np.mean(bg_sample))
    kappa_sigma = max(float(np.std(bg_sample)), 1e-9)

    # --- Platt pre-pass over judged docs -----------------------------------
    platt_sims, platt_labels = [], []
    for qi, qid in enumerate(qids_list):
        for did, rel in ds.qrels.get(qid, {}).items():
            if did in doc_pos:
                platt_sims.append(dense_all[qi, doc_pos[did]])
                platt_labels.append(1.0 if rel > 0 else 0.0)
    platt = PlattCalibrator()
    if len(platt_sims) >= 10 and len(set(platt_labels)) > 1:
        platt.fit(np.asarray(platt_sims), np.asarray(platt_labels),
                  learning_rate=0.1, max_iterations=2000)
    log("kappa + platt calibrators ready")

    # --- per-query hybrid loop ---------------------------------------------
    runs: dict[str, dict] = {}
    # Calibration diagnostics (reference hybrid_beir.py:2492-2546): for
    # probability-producing methods, keep fused values at JUDGED docs so
    # ECE/Brier/LogLoss can be computed over (prob, relevance) pairs.
    cal_store: dict[str, dict] = {}

    def add(method, qid, union_ids, fused_scores):
        if not want(method):
            return
        order = np.argsort(-fused_scores)
        runs.setdefault(method, {})[qid] = [
            doc_ids[union_ids[i]] for i in order[:max(k, 100)]
        ]
        if method in CALIBRATION_METHODS:
            judged = ds.qrels.get(qid)
            if judged:
                pairs = cal_store.setdefault(method, {"p": [], "y": []})
                for i, u in enumerate(union_ids):
                    rel = judged.get(doc_ids[u])
                    if rel is not None:
                        pairs["p"].append(float(fused_scores[i]))
                        pairs["y"].append(1.0 if rel > 0 else 0.0)

    attn_cache = []  # (qid, union_ids, signals2, vpt_signals, feat3, feat7)

    for qi, qid in enumerate(qids_list):
        bs = bm25_all[qi]
        dsim = dense_all[qi]
        bm25_top = np.argsort(-bs)[:R]
        dense_top = np.argsort(-dsim)[:R]
        union = np.union1d(bm25_top, dense_top)
        u_bs = bs[union]
        u_dsim = dsim[union]
        u_probs = {key: probs_all[key][qi][union] for key in probs_all}
        u_dense_prob = np.asarray(cosine_to_probability(u_dsim))

        # Baselines
        add("BM25", qid, union, u_bs)
        add("Dense", qid, union, u_dsim)
        add("Convex", qid, union, 0.5 * _minmax(u_dsim) + 0.5 * _minmax(u_bs))
        rrf = 1.0 / (RRF_K + _rank_of(u_bs) + 1) + \
            1.0 / (RRF_K + _rank_of(u_dsim) + 1)
        add("RRF", qid, union, rrf)

        # Boolean / log-odds fusions
        pair = np.column_stack([u_probs["plain"], u_dense_prob])
        add("Bayesian-OR", qid, union, np.asarray(prob_or(pair)))
        add("Bayesian-LogOdds", qid, union,
            np.asarray(log_odds_conjunction(pair, alpha=0.5)))

        # Local per-query calibration (hybrid_beir.py:1803-1805)
        pos_scores = u_bs[u_bs > 0]
        if len(pos_scores) >= 2 and np.std(pos_scores) > 0:
            local = BayesianProbabilityTransform(
                alpha=1.0 / float(np.std(pos_scores)),
                beta=float(np.median(pos_scores)),
            )
            u_local = np.where(
                u_bs > 0,
                np.asarray(local.likelihood(u_bs)), 0.0,
            )
        else:
            u_local = u_probs["plain"]
        add("Bayesian-LogOdds-Local", qid, union, np.asarray(
            log_odds_conjunction(
                np.column_stack([np.clip(u_local, 1e-10, 1), u_dense_prob]),
                alpha=0.5,
            )))

        pair_br = np.column_stack([u_probs["auto"], u_dense_prob])
        add("Bayesian-LogOdds-BR", qid, union,
            np.asarray(log_odds_conjunction(pair_br, alpha=0.5)))

        # Balanced family (mixture/elbow scorers may be skipped when a
        # filtered method list never asks for them)
        for name, key in (("Bayesian-Balanced", "auto"),
                          ("Bayesian-Balanced-Mix", "mixture"),
                          ("Bayesian-Balanced-Elbow", "elbow")):
            if key not in u_probs:
                continue
            add(name, qid, union, np.asarray(
                balanced_log_odds_fusion(
                    np.clip(u_probs[key], 1e-10, 1 - 1e-10), u_dsim, 0.5)))

        # Gated variants
        for name, gate, beta in (
            ("Bayesian-Gated-ReLU", "relu", 1.0),
            ("Bayesian-Gated-Swish", "swish", 1.0),
            ("Bayesian-Gated-GELU", "gelu", 1.0),
            ("Bayesian-Gated-Swish-B2", "swish", 2.0),
            ("Bayesian-Gated-Softplus", "softplus", 1.0),
        ):
            add(name, qid, union, np.asarray(log_odds_conjunction(
                pair, alpha=0.5, gating=gate, gating_beta=beta)))

        # Dense calibration baselines
        add("Dense-Kappa", qid, union, np.asarray(
            1 / (1 + np.exp(-(u_dsim - kappa_mu) / kappa_sigma))))
        add("Dense-Arctan", qid, union, 0.5 + np.arctan(u_dsim) / np.pi)
        add("Dense-Platt", qid, union, np.asarray(platt(u_dsim)))

        # VPT: background from full dense scores (or IVF residuals).
        # The whole VPT family (and the vector-fused + attention methods
        # that consume vpt_pair) can be skipped when filtered out — the
        # per-query KDE fits dominate the loop's cost.
        # Only the VPT family and Vector-* fusions (incl. Vector-Attn,
        # which trains on vpt_pair) need the per-query KDE fits — the
        # plain attention/multi-head methods train on `pair`.
        # VPT protocol (reference hybrid_beir.py:1888-2033): background
        # from full dense scores (or IVF residuals); the f_R SAMPLE is
        # the dense top-R candidate list; eval points are the union.
        # Each VPT method forces its estimator path — BM25Weights pins
        # KDE with sharpened lexical-only weights, DensityPrior pins GMM
        # with structural weights — and reports the ADDITIVE LOG-ODDS
        # fusion with the base-rate lexical probabilities
        # (fusion_vpt_balanced), not the raw dense calibration. Routing
        # both through method="auto" (the pre-round-5 behavior) let gap
        # detection override the guidance and collapsed every VPT
        # variant onto one estimate.
        need_vpt = want_family("VPT") or want_family("Vector")
        if need_vpt:
            if ivf is not None:
                bg = ivf.background_distances
            else:
                bg = 1.0 - dsim
            vpt = VectorProbabilityTransform.fit_background(np.asarray(bg))
            u_dist = 1.0 - u_dsim
            s_idx = dense_top
            s_dist = 1.0 - dsim[s_idx]
            s_lex_probs = probs_all["auto"][qi][s_idx]
            s_active = bs[s_idx] > 0
            s_density_prior = None
            if ivf is not None:
                cells_s = ivf.assignments[s_idx]
                s_density_prior = np.asarray(ivf_density_prior(
                    ivf.cell_populations[cells_s], ivf.avg_population))
            guidance = _vpt_sample_guidance(
                s_lex_probs, s_active, s_density_prior)
            vpt_probs = np.asarray(vpt.calibrate_with_sample(
                u_dist, s_dist, weights=guidance))
        else:
            vpt_probs = u_dense_prob  # placeholder; consumers filtered out

        if need_vpt and want("VPT-BM25Weights"):
            # CI-violating cross-modal estimator: lexical-only weights
            # (zero where BM25 is silent), sharpened, forced KDE.
            w_bm25 = np.where(s_active, s_lex_probs, 0.0)
            vpt_bm25 = np.asarray(vpt.calibrate_with_sample(
                u_dist, s_dist,
                weights=np.asarray(vpt._sharpen_weights(w_bm25)),
                method="kde"))
            add("VPT-BM25Weights", qid, union,
                _fusion_vpt_balanced(u_probs["auto"], vpt_bm25))

        # Bandwidth ablation variants (reference README bandwidth table,
        # README.md:566-569: "the KDE estimation with BM25 importance
        # weights" — the Silverman factor c sweeps the BM25-weighted
        # KDE estimator, the rank-changing f_R).
        if need_vpt and want_family("VPT-BW"):
            w_bw = np.asarray(vpt._sharpen_weights(
                np.where(s_active, s_lex_probs, 0.0)))
            for bw in (0.2, 0.5, 1.0, 2.0):
                vpt_bw = np.asarray(vpt.calibrate_with_sample(
                    u_dist, s_dist, weights=w_bw, method="kde",
                    bandwidth_factor=bw))
                add(f"VPT-BW-{bw}", qid, union,
                    _fusion_vpt_balanced(u_probs["auto"], vpt_bw))

        if need_vpt and want("VPT-DensityPrior"):
            # CI-compliant structural estimator: density-only weights,
            # forced GMM (never sees the lexical signal).
            if s_density_prior is not None:
                w_dp = s_density_prior
            else:
                gap_w = vpt._gap_weights(s_dist)
                w_dp = (gap_w if gap_w is not None else
                        np.asarray(vpt._distance_density_weights(s_dist)))
            vpt_dp = np.asarray(vpt.calibrate_with_sample(
                u_dist, s_dist, weights=w_dp, method="gmm"))
            add("VPT-DensityPrior", qid, union,
                _fusion_vpt_balanced(u_probs["auto"], vpt_dp))

        # Optional per-query separability gating (hybrid_beir.py:1928-1963):
        # blend the VPT-calibrated dense signal with the global kappa
        # calibration by how separable this query's neighborhood looks.
        if vpt_query_gating:
            sorted_top = np.sort(u_dsim)[::-1]
            if ivf is not None:
                res_g = ivf.search(
                    np.asarray(query_emb[qi], dtype=np.float32),
                    k=min(50, len(union)), nprobe=ivf_nprobe)
                diag = build_ivf_search_diagnostics(
                    res_g.scores, res_g.cell_ids, res_g, ivf)
            else:
                diag = build_exact_search_diagnostics(sorted_top)
            gate = separability_gate(diag)
            kappa_probs = 1 / (1 + np.exp(-(u_dsim - kappa_mu) / kappa_sigma))
            gated = gate * vpt_probs + (1.0 - gate) * kappa_probs
            add("VPT-Gated", qid, union, gated)
            add("Bayesian-Vector-Gated", qid, union, np.asarray(
                balanced_log_odds_fusion(
                    np.clip(u_probs["auto"], 1e-10, 1 - 1e-10),
                    2 * np.clip(gated, 1e-10, 1 - 1e-10) - 1, 0.5)))

        # Vector-calibrated fusion (reference hybrid_beir.py:1953-1969):
        # additive log-odds of the base-rate lexical probs with the
        # auto-routed VPT dense calibration.
        vpt_pair = np.column_stack([
            np.clip(u_probs["auto"], 1e-10, 1 - 1e-10),
            np.clip(vpt_probs, 1e-10, 1 - 1e-10),
        ])
        add("Bayesian-Vector-Balanced", qid, union,
            _fusion_vpt_balanced(u_probs["auto"], vpt_probs))
        add("Bayesian-Vector-Softplus", qid, union, np.asarray(
            log_odds_conjunction(vpt_pair, alpha=0.5, gating="softplus",
                                 max_logit=10.0)))

        # Multi-field
        if mf is not None:
            mf_probs = mf_probs_all[qi][union]
            add("Bayesian-MultiField", qid, union, mf_probs)
            add("Bayesian-MultiField-Bal", qid, union, np.asarray(
                balanced_log_odds_fusion(
                    np.clip(mf_probs, 1e-10, 1 - 1e-10), u_dsim,
                    mf_bal_weight)))

        # Attention feature cache
        feat3 = _query_features_basic(query_tokens[qi], u_bs)
        feat7 = _query_features_rich(
            feat3, u_dsim, bm25_top[:100], dense_top[:100])
        attn_cache.append((qid, union, pair, vpt_pair, feat3, feat7))

    log(f"per-query hybrid loop done ({len(runs)} base methods)")

    # --- attention training (pos = judged, neg <= pos sampled unjudged) ----
    # Standardize query features: the raw features mix scales (log counts,
    # ratios, similarities), which slows/underfits the linear-softmax map.
    feat3_all = np.stack([c[4] for c in attn_cache])
    feat7_all = np.stack([c[5] for c in attn_cache])

    def make_standardizer(feats):
        mu = feats.mean(axis=0)
        sd = np.maximum(feats.std(axis=0), 1e-6)
        return lambda f: (f - mu) / sd

    std3 = make_standardizer(feat3_all)
    std7 = make_standardizer(feat7_all)

    def collect_training(signal_index, feature_index):
        X, y, F, qgrp = [], [], [], []
        for row, (qid, union, pair, vpt_pair, feat3, feat7) in enumerate(
                attn_cache):
            judged = ds.qrels.get(qid, {})
            pos = [i for i, u in enumerate(union)
                   if judged.get(doc_ids[u], 0) > 0]
            if not pos:
                continue
            neg_pool = [i for i, u in enumerate(union)
                        if judged.get(doc_ids[u], 0) <= 0]
            neg = list(rng.choice(len(neg_pool),
                                  size=min(len(pos), len(neg_pool)),
                                  replace=False)) if neg_pool else []
            signals = pair if signal_index == 0 else vpt_pair
            feats = (std3(feat3) if feature_index == 0 else std7(feat7))
            for i in pos:
                X.append(signals[i]); y.append(1.0); F.append(feats)
                qgrp.append(row)
            for j in neg:
                X.append(signals[neg_pool[j]]); y.append(0.0); F.append(feats)
                qgrp.append(row)
        return (np.asarray(X), np.asarray(y), np.asarray(F),
                np.asarray(qgrp))

    def eval_attention(model, name, signal_index, feature_index,
                       use_averaged=False):
        for (qid, union, pair, vpt_pair, feat3, feat7) in attn_cache:
            signals = pair if signal_index == 0 else vpt_pair
            feats = (std3(feat3) if feature_index == 0 else std7(feat7))
            fused = model(np.clip(signals, 1e-10, 1 - 1e-10),
                          np.tile(feats, (len(union), 1)), use_averaged)
            add(name, qid, union, np.atleast_1d(np.asarray(fused)))

    need_attn = want("Attn") or want("MultiHead")
    X3 = y3 = F3 = None
    if need_attn:
        X3, y3, F3, _ = collect_training(0, 0)
    if need_attn and len(X3) >= 10 and len(set(y3)) > 1:
        if want("Bayesian-Attention"):
            attn = AttentionLogOddsWeights(2, 3, alpha=0.5, seed=0)
            attn.fit(np.clip(X3, 1e-10, 1 - 1e-10), y3, F3,
                     learning_rate=0.05, max_iterations=attn_iters)
            eval_attention(attn, "Bayesian-Attention", 0, 0)

        X7, y7, F7, qg7 = collect_training(0, 1)
        if want("Attn-Norm"):
            attn_norm = AttentionLogOddsWeights(2, 7, alpha=0.5, seed=0,
                                                normalize=True)
            attn_norm.fit(np.clip(X7, 1e-10, 1 - 1e-10), y7, F7,
                          query_ids=qg7,
                          learning_rate=0.05, max_iterations=attn_iters)
            eval_attention(attn_norm, "Bayesian-Attn-Norm", 0, 1)

        # 5-fold CV variant (hybrid_beir.py:1359-1443): average fold models
        if want("Attn-Norm-CV"):
            folds = np.array_split(np.arange(len(attn_cache)), 5)
            cv_models = []
            for f in range(5):
                train_rows = set(np.concatenate(
                    [folds[g] for g in range(5) if g != f]))
                mask = np.isin(qg7, list(train_rows))
                if mask.sum() < 10 or len(set(y7[mask])) < 2:
                    continue
                m = AttentionLogOddsWeights(2, 7, alpha=0.5, seed=0,
                                            normalize=True)
                m.fit(np.clip(X7[mask], 1e-10, 1 - 1e-10), y7[mask],
                      F7[mask], query_ids=qg7[mask],
                      learning_rate=0.05, max_iterations=attn_iters // 2)
                cv_models.append((f, m))
            if cv_models:
                fold_of_row = {}
                for f, rows in enumerate(folds):
                    for r in rows:
                        fold_of_row[int(r)] = f
                for row, (qid, union, pair, _, _, feat7) in enumerate(
                        attn_cache):
                    f = fold_of_row.get(row, 0)
                    model = next((m for ff, m in cv_models if ff == f),
                                 cv_models[0][1])
                    fused = model(np.clip(pair, 1e-10, 1 - 1e-10),
                                  np.tile(std7(feat7), (len(union), 1)))
                    add("Bayesian-Attn-Norm-CV", qid, union,
                        np.atleast_1d(np.asarray(fused)))

        # Multi-head (4 heads x basic / rich+norm)
        if want("MultiHead"):
            mh = MultiHeadAttentionLogOddsWeights(4, 2, 3, alpha=0.5)
            mh.fit(np.clip(X3, 1e-10, 1 - 1e-10), y3, F3,
                   learning_rate=0.05, max_iterations=attn_iters // 2)
            eval_attention(mh, "Bayesian-MultiHead", 0, 0)
            mh_norm = MultiHeadAttentionLogOddsWeights(4, 2, 7, alpha=0.5,
                                                       normalize=True)
            mh_norm.fit(np.clip(X7, 1e-10, 1 - 1e-10), y7, F7,
                        learning_rate=0.05, max_iterations=attn_iters // 2)
            eval_attention(mh_norm, "Bayesian-MultiHead-Norm", 0, 1)

        # Vector-calibrated attention
        if want("Vector-Attn"):
            Xv, yv, Fv, qgv = collect_training(1, 1)
            if len(Xv) >= 10 and len(set(yv)) > 1:
                vattn = AttentionLogOddsWeights(2, 7, alpha=0.5, seed=0,
                                                normalize=True)
                vattn.fit(np.clip(Xv, 1e-10, 1 - 1e-10), yv, Fv,
                          query_ids=qgv,
                          learning_rate=0.05, max_iterations=attn_iters)
                eval_attention(vattn, "Bayesian-Vector-Attn", 1, 1)
        log("attention / multi-head methods trained + evaluated")
    elif need_attn:
        log("skipping attention methods: insufficient training data")

    # --- supervised tuning (--tune) ----------------------------------------
    if tune:
        half = len(qids_list) // 2
        train_q = set(qids_list[:half])
        # Collect (score, label) pairs on train queries
        tr_scores, tr_labels = [], []
        for qi, qid in enumerate(qids_list[:half]):
            judged = ds.qrels.get(qid, {})
            for did, rel in judged.items():
                if did in doc_pos:
                    tr_scores.append(bm25_all[qi, doc_pos[did]])
                    tr_labels.append(1.0 if rel > 0 else 0.0)
            negs = rng.choice(len(doc_ids), size=min(50, len(doc_ids)),
                              replace=False)
            for d in negs:
                if doc_ids[d] not in judged:
                    tr_scores.append(bm25_all[qi, d])
                    tr_labels.append(0.0)
        tuned_t = BayesianProbabilityTransform(
            alpha=bm25.transform.alpha, beta=bm25.transform.beta)
        if len(tr_scores) >= 10 and len(set(tr_labels)) > 1:
            tuned_t.fit(np.asarray(tr_scores), np.asarray(tr_labels),
                        learning_rate=0.05, max_iterations=2000)

        # Grid search on train split — the reference's sequential protocol
        # (hybrid_beir.py:1001-1093): phase B sweeps base_rate (incl. the
        # auto-estimated rate) on the plain Bayesian run, phase C sweeps
        # fusion_weight at the best base rate, phase D sweeps hybrid_alpha
        # for the log-odds-AND run at the best base rate.
        auto_br = scorers["auto"].base_rate
        base_rates = [None, 1e-3, 5e-3, 1e-2, 5e-2, 0.1]
        if auto_br is not None and not any(
                br is not None and abs(br - auto_br) < 1e-10
                for br in base_rates):
            base_rates.append(float(auto_br))
        fusion_ws = np.arange(0.0, 1.01, 0.1)
        hybrid_alphas = [0.0, 0.25, 0.5, 0.75, 1.0]

        def tuned_probs(qi, union, br):
            t = BayesianProbabilityTransform(
                alpha=tuned_t.alpha, beta=tuned_t.beta, base_rate=br)
            bs = bm25_all[qi][union]
            doc_idx = union
            dlr = np.asarray([len(corpus_tokens[d]) for d in doc_idx]) / \
                bm25.avgdl
            tfs = np.asarray([
                len(set(query_tokens[qi]) & set(corpus_tokens[d]))
                for d in doc_idx
            ], dtype=float)
            p = np.where(bs > 0, np.asarray(
                t.score_to_probability(bs, tfs, dlr)), 0.0)
            return p

        def train_eval(make_scores_fn):
            run = {}
            for qi, qid in enumerate(qids_list[:half]):
                _, union, pair, _, _, _ = attn_cache[qi]
                fused = make_scores_fn(qi, union)
                order = np.argsort(-fused)
                run[qid] = [doc_ids[union[i]] for i in order[:k]]
            m = evaluate_run(run, {q: ds.qrels[q] for q in train_q
                                   if q in ds.qrels}, k=k)
            return m[f"ndcg@{k}"]

        # Phase B: base_rate on the plain Bayesian run
        best_br, best_br_ndcg = None, -1.0
        for br in base_rates:
            s = train_eval(lambda qi, u: tuned_probs(qi, u, br))
            if s > best_br_ndcg:
                best_br_ndcg, best_br = s, br

        # Phase C: fusion_weight at the best base rate (balanced fusion)
        def balanced_scores(qi, union, w):
            p = tuned_probs(qi, union, best_br)
            return np.asarray(balanced_log_odds_fusion(
                np.clip(p, 1e-10, 1 - 1e-10), dense_all[qi][union], w))

        best_w, best_w_ndcg = 0.5, -1.0
        for w in fusion_ws:
            w = round(float(w), 2)
            s = train_eval(lambda qi, u: balanced_scores(qi, u, w))
            if s > best_w_ndcg:
                best_w_ndcg, best_w = s, w

        # Phase D: hybrid_alpha for the log-odds-AND run at the best rate
        def hybrid_and_scores(qi, union, ha):
            p = tuned_probs(qi, union, best_br)
            u_dense_prob = np.asarray(
                cosine_to_probability(dense_all[qi][union]))
            return np.asarray(log_odds_conjunction(np.column_stack([
                np.clip(p, 1e-10, 1 - 1e-10), u_dense_prob]), alpha=ha))

        best_ha, best_ha_ndcg = 0.5, -1.0
        for ha in hybrid_alphas:
            s = train_eval(lambda qi, u: hybrid_and_scores(qi, u, ha))
            if s > best_ha_ndcg:
                best_ha_ndcg, best_ha = s, ha

        log(f"grid search best: br={best_br} (ndcg={best_br_ndcg:.4f}) "
            f"w={best_w} (ndcg={best_w_ndcg:.4f}) "
            f"hybrid_alpha={best_ha} (ndcg={best_ha_ndcg:.4f})")

        for qi, qid in enumerate(qids_list):
            _, union, pair, _, _, _ = attn_cache[qi]
            p = tuned_probs(qi, union, best_br)
            add("Bayesian-Balanced-Tuned", qid, union, np.asarray(
                balanced_log_odds_fusion(np.clip(p, 1e-10, 1 - 1e-10),
                                         dense_all[qi][union], best_w)))
            add("Bayesian-Tuned", qid, union, p)
            add("Bayesian-Hybrid-AND-Tuned", qid, union,
                hybrid_and_scores(qi, union, best_ha))
        log("tuned methods evaluated")

    # --- evaluation ---------------------------------------------------------
    results = {}
    for method, run in sorted(runs.items()):
        results[method] = evaluate_run(run, ds.qrels, k=k)
    # Calibration diagnostics over judged (prob, label) pairs
    # (reference hybrid_beir.py:2507-2546): attached to each method's
    # metrics dict; printed by print_results.
    from bayesian_bm25_tpu.utils.metrics import calibration_report

    for method, pairs in cal_store.items():
        if method not in results or len(pairs["p"]) < 2:
            continue
        p = np.clip(np.asarray(pairs["p"], dtype=np.float64), 0.0, 1.0)
        y = np.asarray(pairs["y"], dtype=np.float64)
        if len(set(y)) < 2:
            continue
        rep = calibration_report(p, y)
        results[method]["ece"] = float(rep.ece)
        results[method]["brier"] = float(rep.brier)
        results[method]["logloss"] = float(rep.logloss)
        results[method]["cal_samples"] = int(len(p))
    log(f"evaluated {len(results)} methods")
    return results


def print_results(name: str, results: dict, k: int) -> None:
    print(f"\n=== {name} — NDCG@{k} / MAP@{k} / Recall@{k} ===")
    for method, m in sorted(results.items(),
                            key=lambda kv: -kv[1][f"ndcg@{k}"]):
        print(f"  {method:<28} {m[f'ndcg@{k}']*100:6.2f}  "
              f"{m[f'map@{k}']*100:6.2f}  {m[f'recall@{k}']*100:6.2f}")
    cal = [(method, m) for method, m in sorted(results.items())
           if "ece" in m]
    if cal:
        print("\n  --- Calibration Diagnostics (judged docs) ---")
        print(f"  {'Method':<28} {'ECE':>10} {'Brier':>10} "
              f"{'LogLoss':>10} {'Samples':>8}")
        for method, m in sorted(cal, key=lambda kv: kv[1]["ece"]):
            print(f"  {method:<28} {m['ece']:>10.6f} {m['brier']:>10.6f} "
                  f"{m['logloss']:>10.6f} {m['cal_samples']:>8}")


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--download", nargs="*", default=None,
                    metavar="DATASET",
                    help="BEIR dataset names to download into --cache-dir "
                         "and run (e.g. scifact nfcorpus); equivalent to "
                         "--data-dir on the extracted directories")
    ap.add_argument("--cache-dir", default="~/.cache/beir",
                    help="download/extraction cache for --download")
    ap.add_argument("--data-dir", nargs="*", default=None,
                    help="BEIR-format dataset directories")
    ap.add_argument("--synthetic-docs", type=int, default=2000)
    ap.add_argument("--synthetic-queries", type=int, default=64)
    ap.add_argument("--synthetic-seed", type=int, default=7)
    ap.add_argument("--hard", action="store_true",
                    help="BEIR-difficulty topic->subtopic synthetic family "
                         "(benchmarks/utils.py:synthetic_dataset_hard) — "
                         "the method-ordering gate corpus")
    ap.add_argument("--synthetic-topics", type=int, default=None,
                    help="override topic count (--hard default 120)")
    ap.add_argument("--noise-regimes", action="store_true",
                    help="mixed per-query reliability regimes (the "
                         "attention-fusion win condition)")
    ap.add_argument("--dense-backend", default="auto",
                    choices=["auto", "st", "hash"])
    ap.add_argument("--ivf", action="store_true")
    ap.add_argument("--ivf-cells", type=int, default=None)
    ap.add_argument("--ivf-nprobe", type=int, default=None)
    ap.add_argument("--ivf-iterations", type=int, default=10)
    ap.add_argument("--ivf-seed", type=int, default=42)
    ap.add_argument("--vpt-query-gating", action="store_true")
    ap.add_argument("-k", type=int, default=10)
    ap.add_argument("-R", type=int, default=1000)
    ap.add_argument("--tune", action="store_true")
    ap.add_argument("--seed", type=int, default=42,
                    help="harness seed (training sampling etc.)")
    ap.add_argument("--methods", nargs="*", default=None,
                    help="method-name substrings; only matching methods "
                         "are computed (multi-seed ordering studies)")
    ap.add_argument("--device", default="auto", choices=["auto", "cpu"],
                    help="'cpu' forces the CPU backend (sets jax.config "
                         "before backend init, whatever JAX_PLATFORMS "
                         "says)")
    ap.add_argument("-o", "--output", default=None)
    args = ap.parse_args()

    if args.device == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")

    datasets = []
    if args.download:
        from benchmarks.beir_download import download_beir

        dirs = [download_beir(n, args.cache_dir) for n in args.download]
        datasets = [load_beir_dataset(p) for p in dirs]
    elif args.data_dir:
        datasets = [load_beir_dataset(p) for p in args.data_dir]
    elif args.hard:
        from benchmarks.utils import synthetic_dataset_hard

        kw = {}
        if args.synthetic_topics is not None:
            kw["n_topics"] = args.synthetic_topics
        datasets = [synthetic_dataset_hard(
            n_docs=args.synthetic_docs, n_queries=args.synthetic_queries,
            seed=args.synthetic_seed, **kw)]
    else:
        datasets = [synthetic_dataset(
            n_docs=args.synthetic_docs, n_queries=args.synthetic_queries,
            seed=args.synthetic_seed,
            noise_regimes=args.noise_regimes,
            name="synthetic-regimes" if args.noise_regimes
            else "synthetic")]

    all_results = {}
    for ds in datasets:
        print(ds.stats())
        res = run_dataset(
            ds, k=args.k, R=args.R, dense_backend=args.dense_backend,
            use_ivf=args.ivf, ivf_cells=args.ivf_cells,
            ivf_nprobe=args.ivf_nprobe, ivf_iterations=args.ivf_iterations,
            ivf_seed=args.ivf_seed, vpt_query_gating=args.vpt_query_gating,
            tune=args.tune, seed=args.seed, methods=args.methods,
        )
        print_results(ds.name, res, args.k)
        all_results[ds.name] = res

    if args.output:
        with open(args.output, "w") as f:
            json.dump(all_results, f, indent=2)
        print(f"\nresults written to {args.output}")


if __name__ == "__main__":
    main()
