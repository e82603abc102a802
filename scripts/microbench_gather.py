"""Micro-benchmarks: gather/scatter/sort strategies for the hot loops.
Run on the GPU; nothing here is measured yet on the H100."""

import os, sys, time
import numpy as np
import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from sage_icp_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()
import jax.numpy as jnp


def timeit(name, fn, *args, n=20, bytes_moved=None):
    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n
    bw = f"  {bytes_moved / dt / 1e9:8.1f} GB/s" if bytes_moved else ""
    print(f"{name:44s} {dt*1e3:9.3f} ms{bw}", flush=True)
    return dt


def main():
    print(jax.devices(), flush=True)
    C, K = 262144, 40
    rng = np.random.default_rng(0)
    table34 = jnp.asarray(rng.normal(size=(C, K, 4)).astype(np.float32))
    table2 = table34.reshape(C, K * 4)

    # ---- row gathers at different granularities ----
    for nidx in (442368, 110592, 27648):  # 16k*27, 4k*27, 1k*27
        idx = jnp.asarray(rng.integers(0, C, nidx).astype(np.int32))
        nb = nidx * K * 4 * 4
        timeit(f"gather rows [{nidx}] of (40,4) f32", lambda i: table34[i], idx,
               bytes_moved=nb)
        timeit(f"gather rows [{nidx}] of (160,) f32", lambda i: table2[i], idx,
               bytes_moved=nb)
        timeit(f"jnp.take axis0 [{nidx}] of (160,)",
               lambda i: jnp.take(table2, i, axis=0), idx, bytes_moved=nb)

    # ---- small-element gathers (probe pattern) ----
    keys1 = jnp.asarray(rng.integers(0, 2**30, C).astype(np.int32))
    for nidx in (442368 * 8,):  # 16k*27*... probe slots
        idx = jnp.asarray(rng.integers(0, C, nidx).astype(np.int32))
        timeit(f"gather scalars [{nidx}] int32", lambda i: keys1[i], idx,
               bytes_moved=nidx * 4)

    # sorted vs random indices
    idx = jnp.sort(jnp.asarray(rng.integers(0, C, 442368).astype(np.int32)))
    timeit("gather rows [442368] (160,) SORTED idx", lambda i: table2[i], idx,
           bytes_moved=442368 * 640)

    # ---- scatter ----
    upd = jnp.asarray(rng.normal(size=(65536, 4)).astype(np.float32))
    sidx = jnp.asarray(rng.permutation(C)[:65536].astype(np.int32))
    kidx = jnp.asarray(rng.integers(0, K, 65536).astype(np.int32))
    timeit("scatter (65536,4) into (C,K,4) [2d idx]",
           lambda t, i, k, u: t.at[i, k].set(u), table34, sidx, kidx, upd,
           bytes_moved=65536 * 16)
    timeit("scatter (65536,4) unique hint",
           lambda t, i, k, u: t.at[i, k].set(u, unique_indices=True),
           table34, sidx, kidx, upd, bytes_moved=65536 * 16)
    cnt = jnp.zeros((C,), jnp.int32)
    timeit("scatter-add (65536,) int32",
           lambda c, i: c.at[i].add(1), cnt, sidx, bytes_moved=65536 * 4)
    timeit("scatter-add unique+sorted hint",
           lambda c, i: c.at[i].add(1, unique_indices=True,
                                    indices_are_sorted=True),
           cnt, jnp.sort(sidx), bytes_moved=65536 * 4)

    # ---- sorts ----
    vals = jnp.asarray(rng.integers(0, 2**31, 135168).astype(np.uint32))
    pay = jnp.asarray(rng.normal(size=(135168, 4)).astype(np.float32))
    timeit("sort 135k uint32 keys only", lambda v: jnp.sort(v), vals)
    timeit("argsort 135k uint32", lambda v: jnp.argsort(v), vals)
    def sort_kp(v, p):
        o = jnp.argsort(v)
        return v[o], p[o]
    timeit("argsort+gather payload 135k", sort_kp, vals, pay)
    v16 = vals[:16384]
    timeit("argsort 16k uint32", lambda v: jnp.argsort(v), v16)

    # ---- the actual candidate-distance compute shape ----
    q = jnp.asarray(rng.normal(size=(4096, 8, 4)).astype(np.float32))
    cand = jnp.asarray(rng.normal(size=(4096, 27 * K, 4)).astype(np.float32))
    def dist(q, c):
        d = q[:, :, None, :3] - c[:, None, :, :3]
        d2 = jnp.sum(d * d, -1)
        return jnp.min(d2, -1), jnp.argmin(d2, -1)
    timeit("dist+argmin [4096,8,1080]", dist, q, cand,
           bytes_moved=4096 * 8 * 27 * K * 12)


if __name__ == "__main__":
    main()
