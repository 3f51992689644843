"""One-off GPU measurements for the bring-up: Triton block-max vs XLA's
masked reshape-max (kernel and end to end), XLA's sparse-merge gather vs a
large copy, what each matmul precision class and approx_max_k lower to.

    python benchmarks/h100_bringup_measure.py [kernels] [lowering] [e2e]

With no arguments it runs all three parts.
"""

import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import triton as plt  # noqa: E402

import bench  # noqa: E402
from bayesian_bm25_tpu.engine import split_index as sidx  # noqa: E402


def block_max_triton(scores, block, valid_upto, bq=16, num_warps=4,
                     interpret=False):
    nq, D = scores.shape
    G = D // block

    def kernel(x_ref, o_ref):
        j = pl.program_id(1)
        x = x_ref[...]
        col = j * block + jax.lax.broadcasted_iota(jnp.int32, x.shape, 1)
        x = jnp.where(col < valid_upto, x, -jnp.inf)
        o_ref[...] = jnp.max(x, axis=1)

    out = pl.pallas_call(
        kernel, grid=(nq // bq, G),
        in_specs=[pl.BlockSpec((bq, block), lambda i, j: (i, j))],
        out_specs=pl.BlockSpec((None, bq), lambda i, j: (j, i)),
        out_shape=jax.ShapeDtypeStruct((G, nq), jnp.float32),
        compiler_params=plt.CompilerParams(num_warps=num_warps,
                                           num_stages=1),
        interpret=interpret,
    )(scores)
    return out.T


def timeit(fn, *args, reps=20):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3, out


def hlo_lines(fn, *args, pat):
    txt = jax.jit(fn).lower(*args).compile().as_text()
    return [ln.strip()[:300] for ln in txt.splitlines() if re.search(pat, ln)]


def kernel_level():
    rng = np.random.default_rng(0)
    for nq, D, vu in ((8192, 51200, 50000), (1024, 1001472, 1000000)):
        x = jnp.asarray(rng.gamma(2.0, 2.0, (nq, D)).astype(np.float32))
        tiles_fn = jax.jit(lambda s: sidx._block_max(
            s.reshape(s.shape[0], -1, 256), vu))
        t_x, ref = timeit(tiles_fn, x)
        gb = nq * D * 4 / 1e9
        print(f"block-max XLA   ({nq}, {D}): {t_x:.3f} ms "
              f"({gb / t_x * 1e3:.0f} GB/s of the score read)")
        for bq, nw in ((16, 4), (32, 4), (64, 8)):
            fn = jax.jit(lambda s, bq=bq, nw=nw: block_max_triton(
                s, 256, vu, bq, nw))
            t_t, got = timeit(fn, x)
            same = bool(jnp.array_equal(got, ref))
            print(f"block-max Triton({nq}, {D}) bq={bq} warps={nw}: "
                  f"{t_t:.3f} ms ({gb / t_t * 1e3:.0f} GB/s), equal={same}")
        copy = jax.jit(lambda s: s * 2.0)
        t_c, _ = timeit(copy, x)
        print(f"copy (read+write {2 * gb:.2f} GB): {t_c:.3f} ms "
              f"({2 * gb / t_c * 1e3:.0f} GB/s)")
        del x, ref

    for nq, D, nt, cap in ((8192, 51200, 4096, 266),
                           (1024, 1001472, 256, 8202)):
        sc = jnp.asarray(rng.gamma(2.0, 2.0, (nq, D)).astype(np.float32))
        tr = jnp.asarray(np.sort(rng.choice(nq, nt, replace=False))
                         .astype(np.int32))
        sid = jnp.asarray(np.sort(rng.integers(0, D + 1, (nt, cap)),
                                  axis=1).astype(np.int32))
        g = jax.jit(lambda s, r, i: s[r[:, None], jnp.minimum(i, D - 1)])
        t_g, _ = timeit(g, sc, tr, sid)
        n = nt * cap
        print(f"gather ({nq}, {D}) nt={nt} cap={cap}: {t_g:.3f} ms, "
              f"{n / t_g / 1e6:.2f} G elem/s, useful bytes "
              f"{12 * n / t_g / 1e6:.1f} GB/s, sector bytes "
              f"{(8 + 32) * n / t_g / 1e6:.1f} GB/s")
        del sc


def lowering():
    rng = np.random.default_rng(1)
    q = jnp.asarray(rng.integers(0, 3, (512, 2048)).astype(np.float32))
    w = jnp.asarray(rng.gamma(2.0, 1.0, (51200, 2048)).astype(np.float32))
    ref = jnp.dot(q, w.T, precision=jax.lax.Precision.HIGHEST)
    pat = r"custom-call|__cublas|triton|algorithm|fusion\(|dot\("
    for name, prec in (("HIGHEST", jax.lax.Precision.HIGHEST),
                       ("HIGH", jax.lax.Precision.HIGH),
                       ("DEFAULT", jax.lax.Precision.DEFAULT),
                       ("BF16_BF16_F32_X3",
                        jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3)):
        fn = (lambda a, b, p=prec: jnp.dot(a, b.T, precision=p))
        t, out = timeit(jax.jit(fn), q, w)
        rel = float(jnp.max(jnp.abs(out - ref) / jnp.maximum(ref, 1e-3)))
        print(f"f32 dot precision={name}: {t:.3f} ms, max rel err vs "
              f"HIGHEST {rel:.3e}")
        for ln in hlo_lines(fn, q, w, pat=pat)[:4]:
            print("    ", ln)
    qi = q.astype(jnp.int8)
    wi = jnp.asarray(rng.integers(-127, 128, (51200, 2048)).astype(np.int8))
    fn = (lambda a, b: jnp.dot(a, b.T, preferred_element_type=jnp.int32))
    t, _ = timeit(jax.jit(fn), qi, wi)
    print(f"int8 x int8 -> int32 dot (512x2048 @ 2048x51200): {t:.3f} ms")
    for ln in hlo_lines(fn, qi, wi, pat=pat)[:4]:
        print("    ", ln)
    qb, wb = q.astype(jnp.bfloat16), w.astype(jnp.bfloat16)
    fn = (lambda a, b: jnp.dot(a, b.T, preferred_element_type=jnp.float32))
    t, _ = timeit(jax.jit(fn), qb, wb)
    print(f"bf16 x bf16 -> f32 dot (hilo pass): {t:.3f} ms")
    for ln in hlo_lines(fn, qb, wb, pat=pat)[:4]:
        print("    ", ln)

    s = jnp.asarray(rng.gamma(2.0, 2.0, (8192, 50000)).astype(np.float32))
    fn = (lambda x: jax.lax.approx_max_k(x, 10))
    t_a, (va, ia) = timeit(jax.jit(fn), s)
    t_e, (ve, ie) = timeit(jax.jit(lambda x: jax.lax.top_k(x, 10)), s)
    t_b, _ = timeit(jax.jit(lambda x: sidx.exact_topk_blockwise(
        jnp.pad(x, ((0, 0), (0, 1200))), 10, block=256,
        valid_upto=50000)), s)
    recall = np.mean([len(set(a) & set(b)) / 10 for a, b in
                      zip(np.asarray(ia), np.asarray(ie))])
    print(f"approx_max_k (8192, 50000) k=10: {t_a:.3f} ms, recall vs "
          f"top_k {recall:.4f}; lax.top_k {t_e:.3f} ms; "
          f"exact_topk_blockwise {t_b:.3f} ms")
    for ln in hlo_lines(fn, s, pat=r"custom-call|sort|topk|TopK|reduce")[:6]:
        print("    ", ln)


def end_to_end(n_pairs=2):
    from bayesian_bm25_tpu import BayesianBM25Scorer

    rng = np.random.default_rng(0)
    corpus = bench.make_corpus(rng)
    queries = bench.make_queries(rng)
    perm = np.random.default_rng(7)
    batches = [queries] + [[queries[i] for i in perm.permutation(
        len(queries))] for _ in range(4)]
    xla = sidx._block_max

    def triton(tiles, valid_upto):
        nq = tiles.shape[0]
        return block_max_triton(tiles.reshape(nq, -1), tiles.shape[2],
                                valid_upto if valid_upto is not None
                                else tiles.shape[1] * tiles.shape[2])

    for storage in ("int8", None):
        scorer = BayesianBM25Scorer(base_rate=0.01, impact_storage=storage)
        scorer.index(corpus, show_progress=False)
        res = {"xla": [], "triton": []}
        order = ["xla", "triton", "triton", "xla"] * n_pairs
        ref_ids = None
        for name in order:
            sidx._block_max = xla if name == "xla" else triton
            jax.clear_caches()
            outs = scorer.retrieve_many(batches, k=10)   # compile + warm
            if ref_ids is None:
                ref_ids = outs[0][0]
            assert np.array_equal(outs[0][0], ref_ids)
            t0 = time.perf_counter()
            scorer.retrieve_many(batches, k=10)
            dt = time.perf_counter() - t0
            res[name].append(len(batches) * len(queries) / dt)
        sidx._block_max = xla
        print(f"e2e retrieve_many 50k storage={storage or 'hilo'} q/s: "
              + "; ".join(f"{k} {sorted(v)}" for k, v in res.items()))


if __name__ == "__main__":
    parts = sys.argv[1:] or ["kernels", "lowering", "e2e"]
    dev = bench.require_gpu()
    print("card:", bench.card_name_and_power_limit(), "|", dev.device_kind)
    if "kernels" in parts:
        kernel_level()
    if "lowering" in parts:
        lowering()
    if "e2e" in parts:
        end_to_end()
