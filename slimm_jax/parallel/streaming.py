"""Chunk-streaming execution over a device mesh (data x model).

BASELINE.md's flagship configuration — a full database plus an alignment
stream too large for any single device, profiled across every chip of a
(multi-host) slice — composes the two existing execution modes:

  * the chunk-streaming driver (engine.pipeline.profile_file_streaming):
    bounded device memory, decode overlapped with dispatch, pass A
    accumulating coverage across chunk dispatches, pass B re-walking the
    cached chunks against the validity mask (the reference's single
    stream loop, slimm.hpp:194, chunked);
  * the shard_map runners (parallel.runner / parallel.multihost): reads
    routed to data shards by read id, the coverage state optionally
    bin-sharded over a model axis, exact integer psum merges
    (SURVEY.md §2.4).

The composition keeps the pass-A/pass-B accumulators PER DATA SHARD (a
leading mesh axis on every accumulator) so the per-chunk dispatches
contain NO collectives at all — each device accumulates its local partial
histograms; the data-axis psum happens exactly once per pass (at the
cutoff computation and at the pass-B finalize).  All merged quantities
are integer counts, so any (chunking x data x model) factorization is
bit-identical to the single-device whole-file dispatch
(tests/test_streaming.py::test_streaming_sharded_*).

Multi-host: every process streams ITS OWN input slice (read ids are
host-local, reads complete per host); the per-round chunk plan (padded
shard row length + segment plan — static jit arguments) is allgathered so
every process compiles and dispatches the same SPMD program, with hosts
that ran out of chunks dispatching empty rounds until all are drained.
"""

from __future__ import annotations

import sys

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..config import EngineOptions, ProfileOptions
from ..database import SlimmDatabase
from ..engine import pipeline as _pl
from ..engine.pipeline import (_bucket, _contig_sums_nz, _pass_a_local,
                               _pass_b_local, _quantile2_dev,
                               _unpack_read_groups, plan_from_max_run,
                               seg_plan)
from ..state import ProfileState
from ..utils.timer import PhaseTimer


def _route_compact(read_id, rid, pos, S, n_s, n_contigs):
    """Partition one chunk's grouped records over S data-shard rows
    (shard = hash(read id); record order — hence read grouping — preserved
    per shard) in the compact transfer format: bitpacked read boundaries
    (1 bit/record), int16 contig ids (int32 past 32767 contigs), int32
    positions, per-shard valid counts."""
    from .mesh import route_shard

    read_id = np.asarray(read_id)
    rid = np.asarray(rid)
    pos = np.asarray(pos)
    shard = route_shard(read_id, S)
    order = np.argsort(shard, kind="stable")
    counts = np.bincount(shard, minlength=S)
    rdt = np.int16 if n_contigs <= np.iinfo(np.int16).max else np.int32
    bits = np.zeros((S, n_s), np.uint8)
    rid_p = np.zeros((S, n_s), rdt)
    pos_p = np.zeros((S, n_s), np.int32)
    start = 0
    for s in range(S):
        c = int(counts[s]) if s < len(counts) else 0
        sel = order[start:start + c]
        if c:
            r = read_id[sel]
            bits[s, 0] = 1
            np.not_equal(r[1:], r[:-1], out=bits[s, 1:c].view(bool))
            rid_p[s, :c] = rid[sel]
            pos_p[s, :c] = pos[sel]
        start += c
    bnd = np.packbits(bits, axis=1, bitorder="little")
    return bnd, rid_p, pos_p, counts.astype(np.int32)


class ShardedStreamSession:
    """Device-side state of one sharded streaming profile run.

    Accumulators are global jax.Arrays with a leading data-shard axis
    (partial per-shard histograms); the chunk cache mirrors the
    single-device streaming path (device-resident within a byte budget,
    host copies past it)."""

    def __init__(self, runner, geom: dict, dense, *, emit_coverage: bool,
                 device_cache_bytes: int):
        self.mesh = runner.mesh
        shape = dict(zip(self.mesh.axis_names, self.mesh.devices.shape))
        self.D = shape["data"]
        self.M = shape.get("model", 1)
        # rows this process routes into (multi-host: its local shards)
        self.local_rows = getattr(runner, "local_shards", self.D)
        self.multihost = jax.process_count() > 1

        quantum = 1024 * self.M
        self.B = -(-geom["total_bins_pad"] // quantum) * quantum
        self.hist_bins = self.B // self.M
        self.C = geom["n_contigs"]
        self.n_dense = dense.n_dense
        self.n_codes = dense.n_pair_codes
        self.emit = emit_coverage
        self.budget = device_cache_bytes
        self.chunks: list = []
        self._jit_cache: dict = {}

        self._cov_spec = P("data", "model") if self.M > 1 else P("data", None)
        self._sk_code = jnp.asarray(dense.sk_code)
        self._lengths = jnp.asarray(geom["lengths_u32"])
        self._boff = jnp.asarray(geom["bin_offset"])
        self._bends = jnp.asarray(geom["bin_ends"])
        self._half = geom["half"]
        self._bw = geom["bin_width"]
        self._q = geom["q"]
        self._lineage = jnp.asarray(dense.lineage)

        self.cov = self._zeros((self.D, self.B), jnp.int32, self._cov_spec)
        self.uniq_cov = self._zeros((self.D, self.B), jnp.int32,
                                    self._cov_spec)
        self.um = self._zeros((self.D,), jnp.int32, P("data"))

    # -- small helpers -------------------------------------------------------

    def _zeros(self, shape, dtype, spec):
        sh = NamedSharding(self.mesh, spec)
        return jax.jit(lambda: jnp.zeros(shape, dtype), out_shardings=sh)()

    def _globalize(self, bnd, rid_p, pos_p, nv):
        """Host-routed local rows -> global device arrays over the mesh."""
        sh2 = NamedSharding(self.mesh, P("data", None))
        sh1 = NamedSharding(self.mesh, P("data"))
        if self.multihost:
            mk = jax.make_array_from_process_local_data
            return (mk(sh2, bnd), mk(sh2, rid_p), mk(sh2, pos_p),
                    mk(sh1, nv))
        return (jax.device_put(bnd, sh2), jax.device_put(rid_p, sh2),
                jax.device_put(pos_p, sh2), jax.device_put(nv, sh1))

    def _model_slices(self, boff, bends):
        lo = (jax.lax.axis_index("model") * self.hist_bins).astype(jnp.int32)
        hi = lo + self.hist_bins
        return jnp.clip(boff, lo, hi) - lo, jnp.clip(bends, lo, hi) - lo

    # -- per-round plan agreement --------------------------------------------

    def chunk_plan(self, chunk):
        """Agree on the padded shard row length + segment plan for this
        round (static jit arguments: every process must compile the same
        SPMD program).  Returns None when every host is out of chunks."""
        if chunk is None:
            has, per_shard, max_run = 0, 0, 1
        else:
            from .mesh import route_shard

            has = 1
            counts = np.bincount(route_shard(chunk[0], self.local_rows),
                                 minlength=self.local_rows)
            per_shard = int(counts.max()) if counts.size else 0
            max_run, _, _ = seg_plan(chunk[0])
        if self.multihost:
            from jax.experimental import multihost_utils
            g = multihost_utils.process_allgather(
                np.asarray([has, per_shard, max_run], np.int64))
            g = g.reshape(-1, 3)
            has = int(g[:, 0].max())
            per_shard = int(g[:, 1].max())
            max_run = int(g[:, 2].max())
        if has == 0:
            return None
        n_s = _bucket(max(per_shard, 1), 2048)
        k_steps, window = plan_from_max_run(max_run)
        return n_s, k_steps, window

    def sync_totals(self, n_reads: int, hits_count: int):
        if self.multihost:
            from jax.experimental import multihost_utils
            g = multihost_utils.process_allgather(
                np.asarray([n_reads, hits_count], np.int64)).reshape(-1, 2)
            return int(g[:, 0].sum()), int(g[:, 1].sum())
        return n_reads, hits_count

    # -- pass A ---------------------------------------------------------------

    def _get_pass_a(self, n_s, k_steps, window):
        key = ("a", n_s, k_steps, window)
        fn = self._jit_cache.get(key)
        if fn is not None:
            return fn
        M, B, hb, C = self.M, self.B, self.hist_bins, self.C

        def shard_fn(cov, ucov, um, bnd, rid, pos, nv, lengths, boff,
                     half, bw):
            read_id = _unpack_read_groups(bnd[0], n_s, nv[0])
            if M > 1:
                bin_lo = (jax.lax.axis_index("model") * hb).astype(jnp.int32)
                hbins = hb
            else:
                bin_lo, hbins = None, None
            a = _pass_a_local(read_id, rid[0].astype(jnp.int32), pos[0],
                              lengths, boff, half, bw, n_contigs=C,
                              total_bins_pad=B, dedup_window=0,
                              k_steps=k_steps, window=window,
                              bin_lo=bin_lo, hist_bins=hbins)
            return (cov + a["cov"][None], ucov + a["uniq_cov"][None],
                    um + a["uniq_matches"][None])

        cs = self._cov_spec
        mapped = jax.shard_map(
            shard_fn, mesh=self.mesh,
            in_specs=(cs, cs, P("data")) + (P("data", None),) * 3
                     + (P("data"),) + (P(),) * 4,
            out_specs=(cs, cs, P("data")))
        fn = jax.jit(mapped, donate_argnums=(0, 1, 2))
        self._jit_cache[key] = fn
        return fn

    def pass_a_chunk(self, chunk, plan):
        n_s, k_steps, window = plan
        if chunk is None:   # multi-host empty round: others still streaming
            z = np.zeros(0, np.int32)
            chunk = (z, z, z)
        bnd, rid_p, pos_p, nv = _route_compact(chunk[0], chunk[1], chunk[2],
                                               self.local_rows, n_s, self.C)
        g = self._globalize(bnd, rid_p, pos_p, nv)
        nbytes = bnd.nbytes + rid_p.nbytes + pos_p.nbytes
        if self.budget >= nbytes:
            self.budget -= nbytes
            self.chunks.append((g, plan))
        else:
            self.chunks.append(((bnd, rid_p, pos_p, nv), plan))
        fn = self._get_pass_a(n_s, k_steps, window)
        self.cov, self.uniq_cov, self.um = fn(
            self.cov, self.uniq_cov, self.um, g[0], g[1], g[2], g[3],
            self._lengths, self._boff, self._half, self._bw)

    # -- cutoffs ----------------------------------------------------------------

    def _get_cutoffs(self):
        key = ("cut",)
        fn = self._jit_cache.get(key)
        if fn is not None:
            return fn
        M, emit = self.M, self.emit

        def shard_fn(cov, ucov, um, boff, bends, q):
            covm = jax.lax.psum(cov, "data")[0]     # merged local bin slice
            ucovm = jax.lax.psum(ucov, "data")[0]
            um_t = jax.lax.psum(um, "data")[0]
            if M > 1:
                sl, el = self._model_slices(boff, bends)
                rc, nzc = _contig_sums_nz(covm, sl, el)
                urc, nzu = _contig_sums_nz(ucovm, sl, el)
                rc = jax.lax.psum(rc, "model")
                nzc = jax.lax.psum(nzc, "model")
                urc = jax.lax.psum(urc, "model")
                nzu = jax.lax.psum(nzu, "model")
            else:
                rc, nzc = _contig_sums_nz(covm, boff, bends)
                urc, nzu = _contig_sums_nz(ucovm, boff, bends)
            nbins_f = (bends - boff).astype(jnp.float32)
            covp = nzc.astype(jnp.float32) / nbins_f
            ucovp = nzu.astype(jnp.float32) / nbins_f
            sel = urc > 0
            use_cut = q < jnp.float32(1.0)
            cc_q, ucc_q = _quantile2_dev(covp, ucovp, sel, q)
            cc = jnp.where(use_cut, cc_q, jnp.float32(0.0))
            ucc = jnp.where(use_cut, ucc_q, jnp.float32(0.0))
            valid = (rc > 0) & (covp >= cc) & (ucovp >= ucc)
            outs = (rc, urc, nzc, nzu, valid, cc, ucc, um_t)
            if emit:
                outs = outs + (covm, ucovm)
            return outs

        hist_out = P("model") if M > 1 else P()
        out_specs = (P(),) * 8 + ((hist_out,) * 2 if emit else ())
        mapped = jax.shard_map(
            shard_fn, mesh=self.mesh,
            in_specs=(self._cov_spec, self._cov_spec, P("data"),
                      P(), P(), P()),
            out_specs=out_specs)
        fn = jax.jit(mapped)
        self._jit_cache[key] = fn
        return fn

    def cutoffs(self):
        outs = self._get_cutoffs()(self.cov, self.uniq_cov, self.um,
                                   self._boff, self._bends, self._q)
        (self.rc, self.urc, self.nzc, self.nzu, self.valid, self.cc,
         self.ucc, self.um_total) = outs[:8]
        if self.emit:
            self.cov_merged, self.uniq_cov_merged = outs[8], outs[9]
        # pass-B accumulators
        u2_shape = (self.D, self.B) if self.emit else (self.D, self.C)
        u2_spec = self._cov_spec if self.emit else P("data", None)
        self.u2 = self._zeros(u2_shape, jnp.int32, u2_spec)
        self.taxon = self._zeros((self.D, self.n_dense), jnp.int32,
                                 P("data", None))
        self.um2 = self._zeros((self.D,), jnp.int32, P("data"))
        # (contig x code) pair presence, per data shard (see
        # pipeline._pass_b_local) — kilobytes even at full-RefSeq scale
        pair_dom = -(-(self.C * self.n_codes) // 1024) * 1024
        self.pair = self._zeros((self.D, pair_dom), jnp.int8,
                                P("data", None))

    # -- pass B ---------------------------------------------------------------

    def _get_pass_b(self, n_s, k_steps, window):
        key = ("b", n_s, k_steps, window)
        fn = self._jit_cache.get(key)
        if fn is not None:
            return fn
        M, B, hb, C = self.M, self.B, self.hist_bins, self.C
        n_dense, n_codes, emit = self.n_dense, self.n_codes, self.emit

        def shard_fn(u2, taxon, um2, pair, bnd, rid, pos, nv, valid,
                     lineage, sk_code, lengths, boff, half, bw):
            read_id = _unpack_read_groups(bnd[0], n_s, nv[0])
            rid_i = rid[0].astype(jnp.int32)
            rid_c = jnp.clip(rid_i, 0, C - 1)
            center = jnp.minimum(
                pos[0].astype(jnp.uint32) + half.astype(jnp.uint32),
                lengths[rid_c])
            t_gbin = boff[rid_c] + (
                center // bw.astype(jnp.uint32)).astype(jnp.int32)
            nondup = read_id >= 0   # native stream decoder pre-dedups
            if M > 1:
                bin_lo = (jax.lax.axis_index("model") * hb).astype(jnp.int32)
                hbins = hb
            else:
                bin_lo, hbins = None, None
            b = _pass_b_local(read_id, rid_i, t_gbin, nondup, valid, lineage,
                              sk_code, n_contigs=C, total_bins_pad=B,
                              n_dense=n_dense, n_codes=n_codes,
                              k_steps=k_steps, window=window,
                              emit_coverage=emit,
                              bin_lo=bin_lo, hist_bins=hbins)
            u2 = u2 + (b["uniq_cov2"] if emit else b["u2_counts"])[None]
            taxon = taxon + b["taxon_counts"][None]
            um2 = um2 + b["uniq_matches2"][None]
            return u2, taxon, um2, pair | b["pair_levels"][None]

        u2_spec = self._cov_spec if emit else P("data", None)
        mapped = jax.shard_map(
            shard_fn, mesh=self.mesh,
            in_specs=(u2_spec, P("data", None), P("data"), P("data", None))
                     + (P("data", None),) * 3 + (P("data"),) + (P(),) * 7,
            out_specs=(u2_spec, P("data", None), P("data"),
                       P("data", None)))
        fn = jax.jit(mapped, donate_argnums=(0, 1, 2, 3))
        self._jit_cache[key] = fn
        return fn

    def run_pass_b(self):
        for g, plan in self.chunks:
            n_s, k_steps, window = plan
            if not isinstance(g[0], jax.Array):   # host-cached chunk
                g = self._globalize(*g)
            res = self._get_pass_b(n_s, k_steps, window)(
                self.u2, self.taxon, self.um2, self.pair, g[0], g[1], g[2],
                g[3], self.valid, self._lineage, self._sk_code,
                self._lengths, self._boff, self._half, self._bw)
            self.u2, self.taxon, self.um2, self.pair = res
        self.chunks.clear()

    # -- finalize ---------------------------------------------------------------

    def _get_finalize(self):
        key = ("fin",)
        fn = self._jit_cache.get(key)
        if fn is not None:
            return fn
        M, emit = self.M, self.emit

        def shard_fn(u2, taxon, um2, pair, rc, urc, nzc, nzu, valid, um_t,
                     cc, ucc, boff, bends):
            if emit:
                u2m = jax.lax.psum(u2, "data")[0]   # merged bin slice
                if M > 1:
                    sl, el = self._model_slices(boff, bends)
                    u2row, _ = _contig_sums_nz(u2m, sl, el)
                    u2row = jax.lax.psum(u2row, "model")
                else:
                    u2row, _ = _contig_sums_nz(u2m, boff, bends)
            else:
                u2row = jax.lax.psum(u2, "data")[0]
                u2m = jnp.zeros(1, jnp.int32)
            taxon_t = jax.lax.psum(taxon, "data")[0]
            um2_t = jax.lax.psum(um2, "data")[0]
            # per-shard 0/1 presence; the int32 psum is exact at any shard
            # count; bitpacked into the packed tail (8x-smaller fetch)
            ph = jax.lax.psum(pair.astype(jnp.int32), "data")[0]
            # ONE replicated packed vector (unpack_stats layout + pair
            # tail): the whole host finalize fetches once
            scalars = jnp.stack([
                um_t, um2_t,
                jax.lax.bitcast_convert_type(cc, jnp.int32),
                jax.lax.bitcast_convert_type(ucc, jnp.int32),
                jnp.int32(0), jnp.int32(0), jnp.int32(0), jnp.int32(0)])
            packed = jnp.concatenate([
                rc, urc, nzc, nzu, u2row, valid.astype(jnp.int32), scalars,
                taxon_t, _pl._pack_bits_words(ph > 0)])
            outs = (packed,)
            if emit:
                outs = outs + (u2m,)
            return outs

        hist_out = P("model") if M > 1 else P()
        u2_spec = self._cov_spec if emit else P("data", None)
        out_specs = (P(),) + ((hist_out,) if emit else ())
        mapped = jax.shard_map(
            shard_fn, mesh=self.mesh,
            in_specs=(u2_spec, P("data", None), P("data"), P("data", None))
                     + (P(),) * 10,
            out_specs=out_specs)
        fn = jax.jit(mapped)
        self._jit_cache[key] = fn
        return fn

    def finalize_out(self) -> dict:
        """Assemble the same `out` dict the single-device streaming driver
        hands to engine.pipeline._finalize_state — one packed fetch."""
        outs = self._get_finalize()(
            self.u2, self.taxon, self.um2, self.pair, self.rc, self.urc,
            self.nzc, self.nzu, self.valid, self.um_total, self.cc,
            self.ucc, self._boff, self._bends)
        u2m = outs[1] if self.emit else None
        out = dict(packed=np.asarray(outs[0]))
        if self.emit:
            out.update(cov=np.asarray(self.cov_merged),
                       uniq_cov=np.asarray(self.uniq_cov_merged),
                       uniq_cov2=np.asarray(u2m))
        return out


def profile_file_streaming_sharded(options: ProfileOptions,
                                   db: SlimmDatabase, path: str, runner,
                                   engine: EngineOptions | None = None,
                                   chunk_targets: int | None = None
                                   ) -> ProfileState:
    """Chunk-streaming profile of one file over a (data x model) mesh.

    Bit-identical to every other execution mode (whole-file, single-device
    streaming, whole-file sharded) — same integer dataflow.  Falls back to
    the whole-file sharded path when streaming is unavailable."""
    from ..engine import pipeline as pl

    engine = engine or EngineOptions()
    chunk_targets = chunk_targets or engine.stream_chunk or (4 << 20)
    timer = PhaseTimer(enabled=engine.phase_log)

    multihost = jax.process_count() > 1
    timer.start("Streaming alignment chunks ....................... ")
    opened = pl._open_stream(path, engine, chunk_targets)
    if opened is None:
        if multihost:
            # the whole-file fallback would use per-host totals — a
            # silently-wrong profile; fail loudly instead
            raise ValueError(
                "multi-host streaming requires the native stream decoder")
        return pl.profile_file(options, db, path, engine=engine,
                               sharded_runner=runner)
    sr, next_chunk, th = opened
    try:
        first = next_chunk()
    except ValueError as e:
        if "not qname-grouped" in str(e) and not multihost:
            th.join()
            return pl.profile_file(options, db, path, engine=engine,
                                   sharded_runner=runner)
        raise

    avg = sr.avg_read_length
    if multihost:
        # bin_width derives from the sampled average read length
        # (slimm.hpp:412-413, head of the single input stream); the head
        # of the global stream lives on process 0 — broadcast its sample
        # so every process bins identically
        from jax.experimental import multihost_utils
        avg = int(np.asarray(multihost_utils.process_allgather(
            np.asarray([avg], np.int64))).reshape(-1)[0])
    st, dense, geom = pl._stream_init(options, db, sr, avg=avg)
    sess = ShardedStreamSession(
        runner, geom, dense, emit_coverage=engine.fetch_coverage,
        device_cache_bytes=engine.stream_device_cache_bytes)

    c = first
    while True:
        plan = sess.chunk_plan(c)
        if plan is None:
            break
        sess.pass_a_chunk(c, plan)
        if c is not None:
            c = next_chunk()   # decode of the next chunk overlapped dispatch
    th.join()
    n_reads, hits_count, _ = sr.totals()
    n_reads, hits_count = sess.sync_totals(n_reads, hits_count)
    warn = sr.warning()
    if warn:
        print(f"[WARNING] {path}: {warn}", file=sys.stderr)
    st.hits_count = hits_count
    st.matches_count = n_reads
    timer.lap()
    if hits_count == 0:
        print("[WARNING] No mapped reads found in BAM file!", file=sys.stderr)
        return st

    timer.start("Analysing alignments, reads and references ....... ")
    sess.cutoffs()
    sess.run_pass_b()
    out = sess.finalize_out()
    timer.lap()

    t2 = PhaseTimer(enabled=engine.phase_log)
    t2.start("Filtering + LCA (fused above) ..................... ")
    pl._finalize_state(st, out, dense, geom["total_bins"], engine, options,
                       t2)
    return st
