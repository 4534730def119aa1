"""shard_map data-parallel execution of the fused profiling pass.

Reads are routed to shards on the host (shard = hash(read id) mod S,
parallel.mesh.route_shard), so each shard holds every record of its reads
and the grouped-by-read device contract is preserved per shard.  Each shard runs the
same `_fused_core` as the single-device path (slimm_jax.engine.pipeline);
coverage histograms, per-taxid LCA counts and scalar counters merge with
jax.lax.psum over the `data` axis — integer collectives, hence bit-identical
to a single-shard run (tests/test_parallel.py).  Per-contig
occupancy/counters, the quantile cutoffs and the validity mask are derived
from the MERGED histograms inside the same traced computation (replicated
after the psum), so the whole per-file profile is still ONE device dispatch.

This is the reference's single `while (!atEnd)` loop (slimm.hpp:194) turned
into a data-parallel axis (SURVEY.md §2.4); across hosts the same psums
run over the multi-host mesh (parallel.multihost).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..engine.pipeline import _bucket, _fused_core
from .mesh import make_mesh


class ShardedRunner:
    """Drop-in `sharded_runner` for engine.profile_arrays.

    model_shards > 1 adds the bin-axis ("model") dimension: reads are
    data-parallel across `data` shards while the coverage-state histograms
    are sharded over `model` (SURVEY.md §2.4 row 2) — per-device bin memory
    and histogram domain shrink by the model degree.  All merges stay
    integer collectives, so any (data, model) factorization is bit-equal
    to a single device (tests/test_parallel.py).
    """

    def __init__(self, mesh: Mesh | None = None,
                 num_shards: int | None = None, model_shards: int = 1):
        if mesh is None:
            if model_shards > 1:
                import jax as _jax

                from .mesh import make_mesh2
                data = num_shards or len(_jax.devices()) // model_shards
                mesh = make_mesh2(data, model_shards)
            else:
                mesh = make_mesh(num_shards)
        self.mesh = mesh
        shape = dict(zip(mesh.axis_names, mesh.devices.shape))
        self.data_shards = shape["data"]
        self.model_shards = shape.get("model", 1)
        self.n_shards = self.data_shards   # read-routing degree
        self._jit_cache: dict = {}

    # -- host-side read routing ----------------------------------------------

    def _route(self, read_id, rid, pos):
        """Partition records by read so per-read state is shard-local;
        preserves the grouped-by-read order within each shard.  Shard =
        hash(read id) (parallel.mesh.route_shard) so periodic inputs
        don't skew one shard's padded row length; the device uses read
        ids only through equality, so the raw ids ride along unchanged."""
        from .mesh import route_shard

        S = self.n_shards
        valid = read_id >= 0
        shard = np.where(valid, route_shard(read_id, S), -1)
        local_read = np.where(valid, read_id, -1).astype(np.int32)
        order = np.argsort(shard, kind="stable")  # record order kept per shard
        shard_sorted = shard[order]
        counts = np.bincount(shard_sorted[shard_sorted >= 0], minlength=S)
        # 2048-aligned like every record axis (_bucket)
        n_s = _bucket(int(counts.max()) if counts.size else 1, 2048)
        out_read = np.full((S, n_s), -1, np.int32)
        out_rid = np.zeros((S, n_s), np.int32)
        out_pos = np.zeros((S, n_s), np.int32)
        start = int((shard_sorted < 0).sum())
        for s in range(S):
            c = int(counts[s])
            sel = order[start:start + c]
            out_read[s, :c] = local_read[sel]
            out_rid[s, :c] = rid[sel]
            out_pos[s, :c] = pos[sel]
            start += c
        return out_read, out_rid, out_pos, n_s

    # -- jitted shard_map builder ----------------------------------------------

    def _get_fused(self, n_s, **kw):
        key = ("fused", n_s, tuple(sorted(kw.items())))
        fn = self._jit_cache.get(key)
        if fn is not None:
            return fn
        mesh = self.mesh
        has_model = self.model_shards > 1
        emit = kw.get("emit_coverage", True)

        def shard_fn(read_id, rid, pos, lengths_u32, bin_offset, bin_ends,
                     half, bin_width, lineage, sk_code, q):
            out = _fused_core(read_id[0], rid[0], pos[0], lengths_u32,
                              bin_offset, bin_ends, half, bin_width,
                              lineage, sk_code, q, psum_axis="data",
                              model_axis="model" if has_model else None,
                              model_shards=self.model_shards,
                              **kw)
            # the bitpacked (contig x code) pair presence rides in the
            # replicated packed tail — no record-sized pair outputs.
            # emit_coverage=False (-ro/-co off): packed stats only — the
            # bin-domain histograms are neither computed nor materialized,
            # matching the single-device pipeline (pipeline.py _core_after_a)
            if emit:
                return (out["packed"], out["cov"], out["uniq_cov"],
                        out["uniq_cov2"])
            return (out["packed"],)

        hist_spec = P("model") if has_model else P()
        mapped = jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P("data", None),) * 3 + (P(),) * 8,
            out_specs=(P(),) + ((hist_spec,) * 3 if emit else ()))
        fn = jax.jit(mapped)
        self._jit_cache[key] = fn
        return fn

    # -- engine interface ------------------------------------------------------

    def fused(self, read_id, rid, pos, lengths_u32, bin_offset, bin_ends,
              half, bin_width, lineage, sk_code, q, **kw):
        if self.model_shards > 1:
            # every model shard owns an equal 1024-aligned bin slice
            quantum = 1024 * self.model_shards
            kw["total_bins_pad"] = -(-kw["total_bins_pad"] // quantum
                                     ) * quantum
        read2d, rid2d, pos2d, n_s = self._route(read_id, rid, pos)
        fn = self._get_fused(n_s, **kw)
        outs = fn(read2d, rid2d, pos2d, jnp.asarray(lengths_u32),
                  jnp.asarray(bin_offset), jnp.asarray(bin_ends),
                  jnp.asarray(half), jnp.asarray(bin_width),
                  jnp.asarray(lineage), jnp.asarray(sk_code),
                  jnp.asarray(q))
        out = dict(packed=outs[0])
        if kw.get("emit_coverage", True):
            out.update(cov=outs[1], uniq_cov=outs[2], uniq_cov2=outs[3])
        return out
