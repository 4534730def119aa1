#!/usr/bin/env python
"""Profile the coverage-histogram scatter and the per-record table gathers.

Pass A's coverage histograms are XLA scatter-adds over the flat bin
domain (engine/pipeline.py _hist2); pass A's raw binning path gathers two
per-contig columns per record.  This script times, on the default
backend, the candidate formulations at one geometry:

  * one_scatter  — one int32 scatter-add (the floor for one histogram).
  * two_scatters — the plain cov/uniq_cov pair.
  * packed       — ONE uint32 scatter of N elements with both counts
    packed (lo/hi 16-bit fields), split after: what _hist2 runs when no
    bin reaches 2^16.
  * fused2x      — one scatter over a doubled domain (2N elements).
  * presence     — int8 .at[].max(1) occupancy (loses the counts).
  * gath / gathmm (with an ablation geometry, see below) — the two
    per-record table gathers as plain indexed gathers vs a one-hot f32
    matmul at precision HIGHEST (u32 split into exact 16-bit halves);
    gathmm is checked equal to gath before it is timed.
  * passa / full — pass A alone vs the whole fused profile.

Run: python profile_hist.py [n_records] [n_bins_millions] [variants...]
e.g. `python profile_hist.py 8e6 0.4 one_scatter two_scatters packed`.
The ablation variants use bench.make_workload at SLIMM_PH_RECORDS
(10M) x SLIMM_PH_CONTIGS (1000).  Every timing is the median of 5 calls,
each ended by block_until_ready; one JSON line per variant, then one
summary line naming the device.
"""

import json
import sys
import time

import numpy as np


def timeit(fn, *args, reps=5):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main():
    import jax
    import jax.numpy as jnp
    from functools import partial

    n = int(float(sys.argv[1])) if len(sys.argv) > 1 else 9_200_000
    bm = float(sys.argv[2]) if len(sys.argv) > 2 else 12.6
    B = int(bm * 1e6) // 1024 * 1024
    n = -(-n // 2048) * 2048
    rng = np.random.default_rng(0)
    idx = jnp.asarray(rng.integers(0, B, n).astype(np.int32))
    w1 = jnp.asarray(rng.random(n) < 0.95)
    w2 = jnp.asarray(rng.random(n) < 0.80)

    @jax.jit
    def two_scatters(idx, w1, w2):
        i1 = jnp.where(w1, idx, B)
        i2 = jnp.where(w2, idx, B)
        h1 = jnp.zeros(B, jnp.int32).at[i1].add(w1.astype(jnp.int32),
                                                mode="drop")
        h2 = jnp.zeros(B, jnp.int32).at[i2].add(w2.astype(jnp.int32),
                                                mode="drop")
        return h1, h2

    @jax.jit
    def fused2x(idx, w1, w2):
        i = jnp.concatenate([jnp.where(w1, idx, 2 * B),
                             jnp.where(w2, idx + B, 2 * B)])
        h = jnp.zeros(2 * B, jnp.int32).at[i].add(1, mode="drop")
        return h[:B], h[B:]

    @jax.jit
    def packed(idx, w1, w2):
        i = jnp.where(w1 | w2, idx, B)
        v = w1.astype(jnp.int32) + (w2.astype(jnp.int32) << 16)
        h = jnp.zeros(B, jnp.int32).at[i].add(v, mode="drop")
        return h & 0xFFFF, h >> 16

    @jax.jit
    def presence(idx, w1, w2):
        i1 = jnp.where(w1, idx, B)
        h1 = jnp.zeros(B, jnp.int8).at[i1].max(jnp.int8(1), mode="drop")
        i2 = jnp.where(w2, idx, B)
        h2 = jnp.zeros(B, jnp.int8).at[i2].max(jnp.int8(1), mode="drop")
        return h1, h2

    @jax.jit
    def one_scatter(idx, w1):
        i1 = jnp.where(w1, idx, B)
        return jnp.zeros(B, jnp.int32).at[i1].add(w1.astype(jnp.int32),
                                                  mode="drop")

    variants = {"one_scatter": (one_scatter, (idx, w1)),
                "two_scatters": (two_scatters, (idx, w1, w2)),
                "fused2x": (fused2x, (idx, w1, w2)),
                "packed": (packed, (idx, w1, w2)),
                "presence": (presence, (idx, w1, w2))}

    if any(a in ("passa", "full", "gath", "gathmm") for a in sys.argv[3:]):
        # ablation at the REAL large-config geometry: pass A alone vs the
        # whole fused profile (attributes the non-scatter time)
        import os

        import bench
        from slimm_jax.engine.pipeline import (_bucket, _pass_a_local,
                                               fused_profile, seg_plan)
        n_contigs = int(os.environ.get("SLIMM_PH_CONTIGS", 1000))
        wl = bench.make_workload(
            int(os.environ.get("SLIMM_PH_RECORDS", 10_000_000)),
            n_contigs, seed=2)
        bw = np.int32(wl["avg_read_len"])
        nb = wl["lengths"] // np.uint32(bw) + 1
        boff = np.concatenate([[0], np.cumsum(nb)[:-1]]).astype(np.int32)
        bends = (boff + nb).astype(np.int32)
        tbp = -(-int(nb.sum()) // 1024) * 1024
        _, k_steps, window = seg_plan(wl["read_id"])
        npd = _bucket(len(wl["read_id"]))
        rd = np.full(npd, -1, np.int32); rd[:len(wl["read_id"])] = wl["read_id"]
        ri = np.zeros(npd, np.int32); ri[:len(wl["rid"])] = wl["rid"]
        po = np.zeros(npd, np.int32); po[:len(wl["pos"])] = wl["pos"]
        drd, dri, dpo = jnp.asarray(rd), jnp.asarray(ri), jnp.asarray(po)
        dlen = jnp.asarray(wl["lengths"]); dof = jnp.asarray(boff)
        den = jnp.asarray(bends); dlin = jnp.asarray(wl["lineage"])
        dsk = jnp.asarray(wl["sk_code"])
        half = np.int32(wl["avg_read_len"] // 2)
        kw = dict(n_contigs=n_contigs, total_bins_pad=tbp,
                  dedup_window=max(1, window), k_steps=k_steps,
                  window=window)

        pa = jax.jit(partial(_pass_a_local, **kw))

        def passa(a, b, c):
            return pa(a, b, c, dlen, dof, half, bw)["cov"]

        def full(a, b, c):
            return fused_profile(
                a, b, c, dlen, dof, den, half, bw, dlin, dsk,
                np.float32(0.95), n_dense=wl["n_dense"],
                n_codes=wl["n_codes"], emit_coverage=False, **kw)["packed"]

        variants["passa"] = (passa, (drd, dri, dpo))
        variants["full"] = (full, (drd, dri, dpo))

        # the two per-record table gathers of pass A's raw path, plain
        # gather vs one-hot f32 matmul at HIGHEST precision (hi/lo 16-bit
        # split keeps u32 table values exact in f32; default precision
        # may round through TF32 on a GPU)
        @jax.jit
        def gath(rid):
            rc = jnp.clip(rid, 0, n_contigs - 1)
            return dlen[rc], dof[rc]

        tbl = jnp.stack([
            (wl["lengths"] >> 16).astype(np.float32),
            (wl["lengths"] & 0xFFFF).astype(np.float32),
            (boff >> 16).astype(np.float32),
            (boff & 0xFFFF).astype(np.float32)], axis=1)

        @jax.jit
        def gathmm(rid):
            rc = jnp.clip(rid, 0, n_contigs - 1)
            oh = (rc[:, None] == jnp.arange(n_contigs, dtype=jnp.int32)
                  [None, :]).astype(jnp.float32)
            g = jnp.dot(oh, tbl, precision=jax.lax.Precision.HIGHEST)
            hi = g[:, ::2].astype(jnp.int32) << 16
            lo = g[:, 1::2].astype(jnp.int32)
            return ((hi[:, 0] | lo[:, 0]).astype(jnp.uint32),
                    hi[:, 1] | lo[:, 1])

        variants["gath"] = (gath, (dri,))
        variants["gathmm"] = (gathmm, (dri,))
        for x, y in zip(gath(dri), gathmm(dri)):
            assert np.array_equal(np.asarray(x), np.asarray(y)), \
                "one-hot matmul gather is not exact"
    only = [a for a in sys.argv[3:] if a in variants]
    dev = jax.devices()[0]
    r = {"records": n, "bins": B, "platform": dev.platform,
         "device_kind": dev.device_kind}
    for name in (only or list(variants)):
        fn, args = variants[name]
        r[f"{name}_secs"] = timeit(fn, *args)
        print(json.dumps({name: r[f"{name}_secs"]}), flush=True)
    if not only or set(only) >= {"two_scatters", "fused2x", "packed"}:
        a = two_scatters(idx, w1, w2)
        for name, fn in (("fused2x", fused2x), ("packed", packed)):
            b = fn(idx, w1, w2)
            assert np.array_equal(np.asarray(a[0]), np.asarray(b[0])), name
            assert np.array_equal(np.asarray(a[1]), np.asarray(b[1])), name
    print(json.dumps(r))


if __name__ == "__main__":
    main()
