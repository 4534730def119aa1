"""The device pipeline: dense-tensor re-formulation of the profiler.

Division of labor:
  * The decoder (native C++ or Python fallback, slimm_jax/io) interns read
    names and emits dense record arrays (read_id, rid, pos) GROUPED by read
    id.  First-hit-wins (read, contig) dedup — the semantics of
    read_stat::add_target (reference read_stat.hpp:116-135) — happens ON
    DEVICE via windowed shift-compares over the grouped record axis, so the
    host never touches per-record data after decode.  (Decoders may also
    pre-dedup, in which case the device window is 0.)
  * The device runs the ENTIRE per-file profile as ONE fused jit: binning,
    dedup, coverage scatters, per-contig stats, the coverage-quantile
    cutoffs (an exact float32-sequential reimplementation of
    misc.hpp:197-216 as a tiny lax.scan), the contig validity mask, the
    filtered re-dedup and the vectorized LCA.  A single packed int32 vector
    comes back to the host — one device round trip per input file.
  * No device-side sort over the record axis anywhere — the only sort is
    over the n_contigs-sized coverage-percent vector inside the quantile
    cutoff.

  pass A  (records → coverage):
    bin = min(pos + avg_len/2, length[rid]) / bin_width   (slimm.hpp:200-201)
    windowed (read, contig) dedup; per-read target counts → uniqueness;
    coverage histograms over the flat global bin axis (slimm.hpp:219-256)

  cutoffs (device): mass-quantile over cov-percent of contigs with unique
    reads (misc.hpp:197-216, slimm.hpp:328-343, 672-688); validity mask
    (slimm.hpp:351-361)

  pass B  (records + validity mask → LCA):
    re-mask targets by valid contigs (read_stat::update, slimm.hpp:380-390)
    per-read per-level segment min/max over the dense lineage matrix; the
    first level where min == max is the LCA level, and the value is
    lineage[max_rid][level] — exactly the reference's "last inserted wins"
    (std::set iterates ascending, slimm.hpp:516-531)
    scatter-add LCA counts over the dense taxid axis; (lca, contig) pairs
    out for the children sets

Per-read segment reductions run along the grouped record axis either as
D-wide shift windows (D = max targets per read - 1, host-measured; the
common case is D <= 4) or as log-depth doubling scans when runs are long.
Both are pure shifts + elementwise selects (no segment scatters).

The `_fused_core` is shared between the single-device jit below and the
shard_map data-parallel runner (slimm_jax.parallel.runner): all merged
quantities are integer counts, so multi-shard psum merges are exact and
shard count is invisible.

Static shapes: the record axis is padded to bucket sizes so jit caches
compilations across files/batches.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..config import EngineOptions, ProfileOptions
from ..database import DenseTaxonomy, SlimmDatabase, tensorize
from ..state import ProfileState
from ..utils.timer import PhaseTimer

# Widest supported shift-window for device-side dedup / segment reductions;
# reads with more records than this fall back to log-depth scans (and to
# host dedup, which handles arbitrary duplicate spans).
MAX_WINDOW = 4

# The v2 compact transfer carries the local bin as uint16; contigs binned
# finer than this fall back to int32-position transfer (v1).
V2_MAX_BIN = int(np.iinfo(np.uint16).max)


def _bucket(n: int, quantum: int = 8192) -> int:
    """Round up to a padding bucket (limits jit recompiles across files).

    Geometric 1.25x steps bound padding waste at ~25% (power-of-two
    buckets wasted up to 2x — every per-record op pays the padding) while
    keeping the number of distinct compiled shapes logarithmic.  The snap
    to 2048 keeps every record axis a multiple of the 1024-wide rows
    _cumsum_1d reshapes into (and of the 8-bit boundary packing)."""
    if n <= quantum:
        return max(quantum, 1)
    b = float(quantum)
    while b < n:
        b *= 1.25
    return -(-int(b) // 2048) * 2048


# ---------------------------------------------------------------------------
# shared cores (used by both the single-device jit and shard_map shards)
# ---------------------------------------------------------------------------


def _cumsum_1d(x):
    """1-D int32 cumsum via 2-D row scans.  x length must be a multiple of
    1024."""
    m = x.reshape(-1, 1024)
    row = jnp.cumsum(m, axis=1)
    offs = jnp.concatenate([jnp.zeros(1, x.dtype), jnp.cumsum(row[:, -1])[:-1]])
    return (row + offs[:, None]).reshape(-1)


def _unpack_read_groups(bnd_packed, n_pad, n_valid):
    """Reconstruct the grouped read-id array from a bitpacked boundary mask.

    The fused pipeline only ever uses read ids through equality compares
    and `>= 0` validity (segment boundaries), never their absolute values,
    so the host can ship 1 BIT per record (bit = "first record of its
    read", numpy packbits little bit-order) instead of 4 bytes.  Group ids
    are rebuilt on device as cumsum(bits) - 1 and the padded tail
    (>= n_valid) is forced to -1 (the decoder/pad contract in
    _pass_a_local)."""
    bits = (bnd_packed[:, None] >> jnp.arange(8, dtype=jnp.uint8)[None, :]) & 1
    gid = _cumsum_1d(bits.astype(jnp.int32).reshape(-1)) - 1
    idx = jax.lax.iota(jnp.int32, n_pad)
    return jnp.where(idx < n_valid, gid, -1)


def _boundary_sums(values, starts, ends):
    """Per-contig sums over the flat bin axis: cs[ends] - cs[starts].
    Replaces segment_sum over a sorted contig_of_bin map (which compiles
    pathologically on the current toolchain)."""
    cs = jnp.concatenate([jnp.zeros(1, values.dtype), _cumsum_1d(values)])
    return cs[ends] - cs[starts]


def _contig_sums_nz(values, starts, ends):
    """(per-contig sums, per-contig nonzero counts) over the flat bin axis
    in ONE read of `values`.

    Full-cumsum boundary sums read AND write the whole bin axis per counter;
    at full-RefSeq bin counts (tens of millions) that memory traffic
    dominates.  This reads `values` once for 1024-wide row totals (sum + nonzero), does
    a tiny row-prefix cumsum, and reconstructs exact prefix values at the
    2C boundary positions from gathered edge rows."""
    B = values.shape[0]
    R = B // 1024
    m = values.reshape(R, 1024)
    row_tot = jnp.sum(m, axis=1, dtype=jnp.int32)
    row_nz = jnp.sum((m > 0).astype(jnp.int32), axis=1, dtype=jnp.int32)

    Rp = -(-R // 1024) * 1024
    pad = jnp.zeros(Rp - R, jnp.int32)

    def exprefix(rt):
        cs = _cumsum_1d(jnp.concatenate([rt, pad]))
        # exclusive prefix per row + total appended for pos == B
        return jnp.concatenate([jnp.zeros(1, jnp.int32), cs[:R]])

    pre_tot = exprefix(row_tot)
    pre_nz = exprefix(row_nz)

    pos = jnp.concatenate([starts, ends])          # (2C,)
    r = pos // 1024
    c = pos - r * 1024
    rows = m[jnp.clip(r, 0, R - 1)]                # (2C, 1024) edge rows
    colmask = jnp.arange(1024, dtype=jnp.int32)[None, :] < c[:, None]
    part_tot = jnp.sum(jnp.where(colmask, rows, 0), axis=1, dtype=jnp.int32)
    part_nz = jnp.sum(jnp.where(colmask & (rows > 0), 1, 0), axis=1,
                      dtype=jnp.int32)
    cs_tot = pre_tot[r] + part_tot
    cs_nz = pre_nz[r] + part_nz
    C = starts.shape[0]
    return (cs_tot[C:] - cs_tot[:C], cs_nz[C:] - cs_nz[:C])


def _shift_right(x, d, fill):
    pad = jnp.full((d,) + x.shape[1:], fill, x.dtype)
    return jnp.concatenate([pad, x[:-d]], axis=0)


def _shift_left(x, d, fill):
    pad = jnp.full((d,) + x.shape[1:], fill, x.dtype)
    return jnp.concatenate([x[d:], pad], axis=0)


def _seg_end_reduce(t_read, values, combine, identity, *, k_steps, window):
    """Segment reduction along the grouped record axis; END positions of
    each equal-t_read run hold the full-segment reduction afterwards.

    window > 0: direct D-wide shift window (needs window >= max_run - 1).
    window == 0: Hillis-Steele doubling scan, k_steps >= ceil(log2(max_run)).
    """
    if window > 0:
        v = values
        for d in range(1, window + 1):
            same = t_read == _shift_right(t_read, d, jnp.int32(-2))
            if values.ndim > 1:
                same = same[:, None]
            sv = _shift_right(values, d, identity)
            v = combine(v, jnp.where(same, sv, identity))
        return v
    v = values
    for k in range(k_steps):
        d = 1 << k
        same = t_read == _shift_right(t_read, d, jnp.int32(-2))
        if values.ndim > 1:
            same = same[:, None]
        sv = _shift_right(v, d, identity)
        v = combine(v, jnp.where(same, sv, identity))
    return v


def _backfill_from_ends(t_read, end_values, end_mask, fill, *, k_steps,
                        window):
    """Propagate each segment's end value back to every element."""
    y = jnp.where(end_mask, end_values, fill)
    if window > 0:
        src = y
        for d in range(1, window + 1):
            same = t_read == _shift_left(t_read, d, jnp.int32(-3))
            ny = _shift_left(src, d, fill)
            y = jnp.where(same & (y == fill), ny, y)
        return y
    for k in range(k_steps):
        d = 1 << k
        same = t_read == _shift_left(t_read, d, jnp.int32(-3))
        ny = _shift_left(y, d, fill)
        y = jnp.where(same & (y == fill), ny, y)
    return y


def _hist2(idx, w1, w2, n_bins_pad):
    """Two int32 histograms over one index vector (XLA scatter-add; on a
    GPU integer atomics, exact in any order).  Records with both weights
    false contribute nothing.

    Both counts ride ONE uint32 scatter (lo 16 bits = w1 count, hi 16
    bits = w2 count), which halves the scattered elements (profile_hist.py
    measures packed against the plain pair).  Exactness guard: a
    low-field overflow (some bin's w1 count reaching 2^16) carries mass
    into the high field, and a high-field overflow wraps mass out of the
    accumulator entirely — so sum(lo) == sum(w1) AND sum(hi) == sum(w2)
    (cheap int32 reduces; totals < 2^31 by construction) detect ANY
    overflow, and a lax.cond falls back to the two plain scatters for
    deep-coverage inputs (>=65536 reads centered in one bin).  Both
    branches are exact; the guard only picks the fast one."""
    i1 = jnp.where(w1, idx, n_bins_pad)
    i2 = jnp.where(w2, idx, n_bins_pad)

    def two_scatters(_):
        h1 = jnp.zeros(n_bins_pad, jnp.int32).at[i1].add(
            w1.astype(jnp.int32), mode="drop")
        h2 = jnp.zeros(n_bins_pad, jnp.int32).at[i2].add(
            w2.astype(jnp.int32), mode="drop")
        return h1, h2

    ip = jnp.where(w1 | w2, idx, n_bins_pad)
    v = w1.astype(jnp.uint32) + (w2.astype(jnp.uint32) << 16)
    h = jnp.zeros(n_bins_pad, jnp.uint32).at[ip].add(v, mode="drop")
    lo = (h & jnp.uint32(0xFFFF)).astype(jnp.int32)
    hi = (h >> 16).astype(jnp.int32)
    ok = ((jnp.sum(lo) == jnp.sum(w1.astype(jnp.int32)))
          & (jnp.sum(hi) == jnp.sum(w2.astype(jnp.int32))))
    return jax.lax.cond(ok, lambda _: (lo, hi), two_scatters, 0)


def _pack_bits_words(x):
    """Bitpack a 0/1 vector (length a multiple of 32) into int32 words
    whose little-endian byte view equals np.packbits(x, bitorder="little"),
    so the presence map can ride INSIDE the packed int32 stats vector and
    the whole result comes back in ONE device->host fetch."""
    w = (jnp.int32(1) << jnp.arange(32, dtype=jnp.int32))[None, :]
    b = x.reshape(-1, 32).astype(jnp.int32)
    return jnp.sum(b * w, axis=1)  # disjoint bits: wrapping sum == OR


def _hist1(idx, w, n_bins_pad):
    """One int32 histogram (XLA scatter-add); weight-0 records drop."""
    i = jnp.where(w, idx, n_bins_pad)
    return jnp.zeros(n_bins_pad, jnp.int32).at[i].add(
        w.astype(jnp.int32), mode="drop")


def _pass_a_local(read_id, rid, pos, lengths_u32, bin_offset,
                  half, bin_width, *, n_contigs, total_bins_pad,
                  dedup_window, k_steps, window,
                  bin_lo=None, hist_bins=None, t_gbin=None):
    """Grouped records → dedup mask, binning, uniqueness, coverage.

    read_id/rid/pos are int32[N_pad] record arrays padded with read_id ==
    -1, GROUPED by read id (decoder contract).  dedup_window == 0 means the
    input is already dedup'd per (read, contig) with first-hit positions
    (native decoder path); dedup_window >= max_run-1 applies the
    read_stat::add_target first-hit-wins rule on device.

    Under bin-axis ("model") sharding, bin_lo (traced) + hist_bins (static)
    restrict the histograms to this shard's bin range [bin_lo, bin_lo +
    hist_bins): out-of-range records carry zero weight and the local
    domain is hist_bins (SURVEY.md §2.4 row 2).
    """
    valid = read_id >= 0
    rid_c = jnp.clip(rid, 0, n_contigs - 1)
    if t_gbin is None:
        # center-position binning, uint32 wrap semantics (slimm.hpp:200-201);
        # the compact-v2 transfer precomputes the (cheap, exact) bin on the
        # host instead and skips this.  Plain integer gathers: exact on
        # every backend for any u32 table value.
        center = jnp.minimum(
            pos.astype(jnp.uint32) + half.astype(jnp.uint32),
            lengths_u32[rid_c])
        local_bin = (center // bin_width.astype(jnp.uint32)).astype(jnp.int32)
        t_gbin = bin_offset[rid_c] + local_bin

    # first-hit-wins (read, contig) dedup: a record is a duplicate iff an
    # earlier record of the same read hits the same contig
    # (read_stat.hpp:116-135 — the by-value loop keeps only the first bin)
    dup = jnp.zeros(read_id.shape, bool)
    for d in range(1, dedup_window + 1):
        same = read_id == _shift_right(read_id, d, jnp.int32(-2))
        dup = dup | (same & (rid == _shift_right(rid, d, jnp.int32(-1))))
    nondup = valid & ~dup

    # per-read distinct-target count → uniqueness (slimm.hpp:221-239)
    end_mask = valid & (read_id != _shift_left(read_id, 1, jnp.int32(-3)))
    cnt_end = _seg_end_reduce(read_id, nondup.astype(jnp.int32), jnp.add,
                              jnp.int32(0), k_steps=k_steps, window=window)
    total = _backfill_from_ends(read_id, cnt_end, end_mask, jnp.int32(0),
                                k_steps=k_steps, window=window)
    t_uniq = nondup & (total == 1)
    uniq_matches = jnp.sum((end_mask & (cnt_end == 1)).astype(jnp.int32))

    # coverage histograms
    if bin_lo is None:
        hist_idx, w1, w2 = t_gbin, nondup, t_uniq
        dom = total_bins_pad if hist_bins is None else hist_bins
    else:
        hist_idx = t_gbin - bin_lo
        in_range = (hist_idx >= 0) & (hist_idx < hist_bins)
        w1, w2 = nondup & in_range, t_uniq & in_range
        dom = hist_bins
    cov, uniq_cov = _hist2(hist_idx, w1, w2, dom)

    return dict(t_gbin=t_gbin, nondup=nondup, cov=cov, uniq_cov=uniq_cov,
                uniq_matches=uniq_matches)


def _quantile2_dev(vals1, vals2, mask, q):
    """TWO device mass-quantiles over one shared mask in one pair of scans
    (the engine always needs cov + uniq_cov cutoffs together), bit-exact vs
    state.quantile_cut_off (reference misc.hpp:197-216).

    total accumulates float32-sequentially in the original (contig) order;
    the walk descends the sorted values from the top until
    cumulative/total >= q and returns the element below the stop index.
    Zero total yields NaN ratios (NaN < q is False) so the walk breaks at
    the top and returns the max element.  Empty selection returns 0.

    The scans are inherently sequential (bit-exact f32 accumulation order)
    but each step is trivial — unroll=16 amortizes the per-step overhead.
    """
    C = vals1.shape[0]
    vv = jnp.stack([vals1, vals2], axis=1)              # (C, 2)
    contrib = jnp.where(mask[:, None], vv, jnp.float32(0.0))

    def add(c, v):
        return (c + v).astype(jnp.float32), None

    total, _ = jax.lax.scan(add, jnp.zeros(2, jnp.float32), contrib,
                            unroll=16)

    m = mask.sum()
    inf = jnp.float32(np.inf)
    sv = jnp.sort(jnp.where(mask[:, None], vv, inf), axis=0)  # valid asc
    rv = sv[::-1]                                             # inf head
    posn = jnp.arange(C)
    # the reference walks i = n-1 .. 1 (i == 0 is never checked)
    chk = (posn >= C - m) & (posn <= C - 2)

    def step(carry, x):
        sub, found, ans = carry
        v, c = x
        ratio = sub / total
        brk = c & (~found) & jnp.logical_not(ratio < q)
        ans = jnp.where(brk, v, ans)
        found = found | brk
        sub = jnp.where(c & (~found), (sub + v).astype(jnp.float32), sub)
        return (sub, found, ans), None

    (_, found, ans), _ = jax.lax.scan(
        step,
        (jnp.zeros(2, jnp.float32), jnp.zeros(2, bool),
         jnp.zeros(2, jnp.float32)),
        (rv, chk), unroll=16)
    res = jnp.where(found, ans, rv[C - 1])   # fell through → v[0]
    res = jnp.where(m == 0, jnp.float32(0.0), res)
    return res[0], res[1]


def _lineage_rows(lineage, ridx, n_contigs):
    """lineage[clip(ridx)]: (N, 8) integer row gather, exact for any taxid.
    Out-of-range indices (-1 = no target) read row 0 or n_contigs-1;
    callers mask those positions."""
    return lineage[jnp.clip(ridx, 0, n_contigs - 1)]


def _table_col(col, ridx, n_contigs):
    """col[clip(ridx)] for a per-contig integer column (plain gather)."""
    return col[jnp.clip(ridx, 0, n_contigs - 1)]


def _pass_b_local(read_id, rid, t_gbin, nondup, valid_mask, lineage, sk_code,
                  *, n_contigs, total_bins_pad, n_dense, n_codes, k_steps,
                  window, emit_coverage=True, bin_lo=None,
                  hist_bins=None):
    """Filtered re-dedup + vectorized LCA (slimm.hpp:351-392, 516-557).

    emit_coverage=True: one fused bin-domain scatter covers both the
    uniq_cov2 histogram and the per-taxid LCA counts.  emit_coverage=False
    (no -ro/-co output requested): the reports only need PER-CONTIG uniq2
    counts, so the bin-domain histogram is skipped entirely and one small
    fused histogram over [contigs | dense taxids] replaces it — at
    full-RefSeq bin counts that removes pass B's largest op.

    sk_code (int32[n_contigs]) + n_codes (static, = 8 + S) parameterize the
    compact (lca, contig) pair channel — see `pair_levels` below.
    """
    rid_c = jnp.clip(rid, 0, n_contigs - 1)
    tmask = nondup & (_table_col(valid_mask.astype(jnp.int32), rid,
                                 n_contigs) > 0)
    end_mask = (read_id >= 0) & (
        read_id != _shift_left(read_id, 1, jnp.int32(-3)))

    # per-read valid-target count at segment ends
    cnt = _seg_end_reduce(read_id, tmask.astype(jnp.int32), jnp.add,
                          jnp.int32(0), k_steps=k_steps, window=window)
    total = _backfill_from_ends(read_id, cnt, end_mask, jnp.int32(0),
                                k_steps=k_steps, window=window)
    t_u2 = tmask & (total == 1)          # newly-unique (slimm.hpp:383-390)
    multi_end = end_mask & (cnt > 1)

    # --- vectorized LCA over the dense lineage matrix ---
    # "All of a read's valid targets share the same taxid at level l" is
    # equivalent to "every CONSECUTIVE pair of valid targets agrees at l"
    # (targets are grouped per read).  So instead of (N, 8) segment
    # min/max scans, compute one 8-bit disagreement mask per target
    # against its nearest PRECEDING valid target and OR it to the segment
    # end.  The comparison uses SHIFTED copies of the row-gathered lv (one
    # gather total).
    lv = _lineage_rows(lineage, rid, n_contigs)  # (N, 8)
    bitw = (1 << jnp.arange(8, dtype=jnp.int32))[None, :]
    disag_bits = jnp.zeros(read_id.shape, jnp.int32)
    if window > 0:
        prev_found = jnp.zeros(rid.shape, bool)
        for d in range(1, window + 1):
            same = read_id == _shift_right(read_id, d, jnp.int32(-2))
            cand = same & _shift_right(tmask, d, False) & ~prev_found
            bits_d = jnp.sum(
                jnp.where(lv != _shift_right(lv, d, jnp.int32(-1)), bitw, 0),
                axis=1)
            disag_bits = jnp.where(cand, bits_d, disag_bits)
            prev_found = prev_found | cand
    else:
        # long runs: log-depth "nearest preceding valid target" via a
        # doubling scan, then one row gather for its lineage
        enc = jnp.where(tmask, rid, -1)
        # combine(current, earlier): keep the rightmost valid rid
        last_valid = _seg_end_reduce(  # runs at every position, not only ends
            read_id, enc, lambda cur, earl: jnp.where(cur >= 0, cur, earl),
            jnp.int32(-1), k_steps=k_steps, window=0)
        same1 = read_id == _shift_right(read_id, 1, jnp.int32(-2))
        prev_rid = jnp.where(same1,
                             _shift_right(last_valid, 1, jnp.int32(-1)), -1)
        prev_found = prev_rid >= 0
        lv_prev = _lineage_rows(lineage, prev_rid, n_contigs)
        disag_bits = jnp.sum(jnp.where(lv != lv_prev, bitw, 0), axis=1)
    disag_bits = jnp.where(tmask & prev_found, disag_bits, 0)
    disag = _seg_end_reduce(read_id, disag_bits, jnp.bitwise_or,
                            jnp.int32(0), k_steps=k_steps, window=window)
    rid_mx = _seg_end_reduce(read_id, jnp.where(tmask, rid, -1), jnp.maximum,
                             jnp.int32(-1), k_steps=k_steps, window=window)
    # first agreeing level = lowest zero bit of the OR'd disagreement mask
    z = jnp.bitwise_and(jnp.bitwise_not(disag), 0xFF)
    lsb = jnp.bitwise_and(z, -z)
    first_level = jnp.where(z != 0,
                            jax.lax.population_count(lsb - 1), 7)
    # lineage[max_rid][first agreeing level (or 7)] — slimm.hpp:516-531;
    # row gather + one-hot level select
    lv_mx = _lineage_rows(lineage, rid_mx, n_contigs)   # (N, 8)
    lvl_hot = first_level[:, None] == jnp.arange(8, dtype=jnp.int32)[None, :]
    lca_end = jnp.sum(jnp.where(lvl_hot, lv_mx, 0), axis=1)

    out = {}
    lca_clip = jnp.clip(lca_end, 0, n_dense - 1)
    if emit_coverage and bin_lo is not None:
        # model-sharded: local-range uniq_cov2 slice + separate LCA hist
        # (the LCA counts are bin-independent, identical on every model
        # shard — merged over the data axis only)
        li = t_gbin - bin_lo
        in_range = (li >= 0) & (li < hist_bins)
        out["uniq_cov2"] = _hist1(li, t_u2 & in_range, hist_bins)
        ndp = -(-n_dense // 1024) * 1024
        out["taxon_counts"] = _hist1(lca_clip, multi_end, ndp)[:n_dense]
    elif emit_coverage:
        # ONE fused histogram: [0, Bp) = uniq_cov2, [Bp, Bp+n_dense) =
        # per-dense-taxid LCA counts (weight-0 records contribute nothing)
        dom = -(-(total_bins_pad + n_dense) // 1024) * 1024
        idx = jnp.where(t_u2, t_gbin, total_bins_pad + lca_clip)
        combined = _hist1(idx, t_u2 | multi_end, dom)
        out["uniq_cov2"] = combined[:total_bins_pad]
        out["taxon_counts"] = combined[
            total_bins_pad:total_bins_pad + n_dense]
    else:
        # small fused histogram: [0, Cp) = per-contig uniq2 counts,
        # [Cp, Cp+n_dense) = LCA counts — no bin-domain op at all
        cp = -(-n_contigs // 1024) * 1024
        dom = -(-(cp + n_dense) // 1024) * 1024
        idx = jnp.where(t_u2, rid_c, cp + lca_clip)
        combined = _hist1(idx, t_u2 | multi_end, dom)
        out["u2_counts"] = combined[:n_contigs]
        out["taxon_counts"] = combined[cp:cp + n_dense]

    # (lca, contig) pairs for the children sets, as a (contig x level-code)
    # presence map.  The LCA is lineage[max_rid][L] at the read's first
    # agreeing level L, and EVERY valid target r of the read agrees there:
    # lineage[r][L] == lca.  So the pair (lca, r) is recoverable on the
    # host from (r, L) alone — marking bit L of contig r suffices.  The
    # corner where NO level agrees (the reference's get_lca falls through
    # its loop and returns the last-inserted level-7 value,
    # slimm.hpp:516-531 — i.e. lineage[max_rid][7], which need NOT equal
    # lineage[r][7]) uses codes 8..8+S-1: the lca is then one of the S
    # distinct superkingdom-level ids (sk_code[max_rid] picks which).
    # Domain is n_contigs * (8 + S) BITS on the fetch — independent of
    # n_dense, so full-RefSeq DBs fetch kilobytes where an
    # (n_dense x n_contigs) map would fetch megabytes.
    no_agree = z == 0
    code_end = jnp.where(no_agree,
                         8 + _table_col(sk_code, rid_mx, n_contigs),
                         first_level)
    code_b = _backfill_from_ends(read_id, jnp.where(multi_end, code_end, -1),
                                 end_mask, jnp.int32(-1),
                                 k_steps=k_steps, window=window)
    t_multi = tmask & (total > 1)
    pdom = -(-(n_contigs * n_codes) // 1024) * 1024
    pidx = rid_c * n_codes + jnp.clip(code_b, 0, n_codes - 1)
    ph = _hist1(pidx, t_multi, pdom)
    out["pair_levels"] = (ph > 0).astype(jnp.int8)
    out["uniq_matches2"] = jnp.sum((end_mask & (cnt == 1)).astype(jnp.int32))
    return out


# packed layout: 6 rows of n_contigs + 8 scalars + n_dense taxon counts
_N_SCALARS = 8


def _fused_core(read_id, rid, pos, lengths_u32, bin_offset, bin_ends,
                half, bin_width, lineage, sk_code, q, *, n_contigs,
                total_bins_pad, n_dense, n_codes, dedup_window, k_steps,
                window, psum_axis=None, emit_coverage=True,
                model_axis=None, model_shards=1, t_gbin=None):
    """The whole per-file profile in one traced computation.

    Returns dict with `packed` (int32[6*C + 8 + n_dense + pair-words]:
    reads_count, uniq_reads_count, nz_cov, nz_uniq, uniq_reads_count2,
    valid_mask, scalars [uniq_matches, uniq_matches2, cc<bitcast>,
    ucc<bitcast>, ...], taxon_counts, bitpacked (contig x code) pair
    presence), and the full histograms when emit_coverage (needed for
    -ro/-co reports; the abundance path needs only the packed integers).
    Under shard_map, psum_axis names the data axis for the exact integer
    merges; everything after the first psum is replicated computation.
    With model_axis (+ model_shards static), the bin axis is additionally
    sharded: each model shard computes and holds only its
    total_bins_pad/model_shards bin slice (records are replicated along
    model); per-contig counters merge with a psum over the model axis
    (contig ranges crossing shard boundaries sum exactly), after which
    cutoffs/validity are replicated and pass B runs as usual.
    """
    if model_axis is not None:
        assert total_bins_pad % model_shards == 0
        hist_bins = total_bins_pad // model_shards
        bin_lo = (jax.lax.axis_index(model_axis) * hist_bins).astype(
            jnp.int32)
    else:
        hist_bins = None
        bin_lo = None

    a = _pass_a_local(read_id, rid, pos, lengths_u32, bin_offset,
                      half, bin_width, n_contigs=n_contigs,
                      total_bins_pad=total_bins_pad,
                      dedup_window=dedup_window, k_steps=k_steps,
                      window=window,
                      bin_lo=bin_lo, hist_bins=hist_bins, t_gbin=t_gbin)
    return _core_after_a(
        a["cov"], a["uniq_cov"], a["uniq_matches"], read_id, rid,
        a["t_gbin"], a["nondup"], bin_offset, bin_ends, lineage, sk_code, q,
        n_contigs=n_contigs, total_bins_pad=total_bins_pad, n_dense=n_dense,
        n_codes=n_codes, k_steps=k_steps, window=window,
        psum_axis=psum_axis,
        emit_coverage=emit_coverage, model_axis=model_axis,
        model_shards=model_shards, bin_lo=bin_lo, hist_bins=hist_bins)


def _core_after_a(cov, uniq_cov, uniq_matches, read_id, rid, t_gbin, nondup,
                  bin_offset, bin_ends, lineage, sk_code, q, *, n_contigs,
                  total_bins_pad, n_dense, n_codes, k_steps, window,
                  psum_axis=None, emit_coverage=True,
                  model_axis=None, model_shards=1, bin_lo=None,
                  hist_bins=None):
    """Everything in the fused profile AFTER the pass-A histograms:
    histogram merge, per-contig counters, device cutoffs + validity, pass
    B, and the packed-vector assembly.  Shared between the one-dispatch
    paths (_fused_core) and the overlap path's split dispatch, where pass
    A ran incrementally per piece while the file was still decoding."""
    if psum_axis is not None:
        cov = jax.lax.psum(cov, psum_axis)
        uniq_cov = jax.lax.psum(uniq_cov, psum_axis)
        uniq_matches = jax.lax.psum(uniq_matches, psum_axis)

    # per-contig counters from the MERGED histograms (occupancy does not
    # commute with summation); sums + nonzero counts share one pass
    if model_axis is not None:
        lo = bin_lo
        hi = bin_lo + hist_bins
        starts_l = jnp.clip(bin_offset, lo, hi) - lo
        ends_l = jnp.clip(bin_ends, lo, hi) - lo
        rc, nzc = _contig_sums_nz(cov, starts_l, ends_l)
        urc, nzu = _contig_sums_nz(uniq_cov, starts_l, ends_l)
        rc = jax.lax.psum(rc, model_axis)
        nzc = jax.lax.psum(nzc, model_axis)
        urc = jax.lax.psum(urc, model_axis)
        nzu = jax.lax.psum(nzu, model_axis)
    else:
        rc, nzc = _contig_sums_nz(cov, bin_offset, bin_ends)
        urc, nzu = _contig_sums_nz(uniq_cov, bin_offset, bin_ends)

    # device cutoffs + validity mask (slimm.hpp:328-343, 351-361, 672-688)
    nbins_f = (bin_ends - bin_offset).astype(jnp.float32)
    covp = nzc.astype(jnp.float32) / nbins_f
    ucovp = nzu.astype(jnp.float32) / nbins_f
    sel = urc > 0
    use_cut = q < jnp.float32(1.0)
    cc_q, ucc_q = _quantile2_dev(covp, ucovp, sel, q)
    cc = jnp.where(use_cut, cc_q, jnp.float32(0.0))
    ucc = jnp.where(use_cut, ucc_q, jnp.float32(0.0))
    valid_mask = (rc > 0) & (covp >= cc) & (ucovp >= ucc)

    b = _pass_b_local(read_id, rid, t_gbin, nondup, valid_mask,
                      lineage, sk_code, n_contigs=n_contigs,
                      total_bins_pad=total_bins_pad, n_dense=n_dense,
                      n_codes=n_codes, k_steps=k_steps, window=window,
                      emit_coverage=emit_coverage,
                      bin_lo=bin_lo, hist_bins=hist_bins)
    taxon_counts = b["taxon_counts"]
    uniq_matches2 = b["uniq_matches2"]
    if emit_coverage:
        uniq_cov2 = b["uniq_cov2"]
        if psum_axis is not None:
            uniq_cov2 = jax.lax.psum(uniq_cov2, psum_axis)
        if model_axis is not None:
            u2, _ = _contig_sums_nz(uniq_cov2, starts_l, ends_l)
            u2 = jax.lax.psum(u2, model_axis)
        else:
            u2, _ = _contig_sums_nz(uniq_cov2, bin_offset, bin_ends)
    else:
        u2 = b["u2_counts"]
        if psum_axis is not None:
            u2 = jax.lax.psum(u2, psum_axis)
    if psum_axis is not None:
        taxon_counts = jax.lax.psum(taxon_counts, psum_axis)
        uniq_matches2 = jax.lax.psum(uniq_matches2, psum_axis)

    scalars = jnp.stack([
        uniq_matches, uniq_matches2,
        jax.lax.bitcast_convert_type(cc, jnp.int32),
        jax.lax.bitcast_convert_type(ucc, jnp.int32),
        jnp.int32(0), jnp.int32(0), jnp.int32(0), jnp.int32(0)])
    ph = b["pair_levels"]
    if psum_axis is not None:
        # per-shard 0/1 presence; int32 psum is exact at any shard count
        # and any positive value marks the pair (the domain is tiny:
        # n_contigs * n_codes slots)
        ph = jax.lax.psum(ph.astype(jnp.int32), psum_axis)
    # the bitpacked presence map rides INSIDE the packed vector: one fetch
    # round trip for everything the host finalize needs
    packed = jnp.concatenate([rc, urc, nzc, nzu, u2,
                              valid_mask.astype(jnp.int32), scalars,
                              taxon_counts, _pack_bits_words(ph > 0)])
    out = dict(packed=packed)
    if emit_coverage:
        out.update(cov=cov, uniq_cov=uniq_cov, uniq_cov2=uniq_cov2)
    return out


@partial(jax.jit, static_argnames=("n_contigs", "total_bins_pad", "n_dense",
                                   "n_codes", "dedup_window", "k_steps",
                                   "window", "emit_coverage"))
def fused_profile(read_id, rid, pos, lengths_u32, bin_offset, bin_ends,
                  half, bin_width, lineage, sk_code, q, *, n_contigs,
                  total_bins_pad, n_dense, n_codes, dedup_window, k_steps,
                  window, emit_coverage=True):
    return _fused_core(read_id, rid, pos, lengths_u32, bin_offset, bin_ends,
                       half, bin_width, lineage, sk_code, q,
                       n_contigs=n_contigs, total_bins_pad=total_bins_pad,
                       n_dense=n_dense, n_codes=n_codes,
                       dedup_window=dedup_window, k_steps=k_steps,
                       window=window,
                       emit_coverage=emit_coverage)


@partial(jax.jit, static_argnames=("n_contigs", "total_bins_pad", "n_dense",
                                   "n_codes", "dedup_window", "k_steps",
                                   "window", "emit_coverage"))
def fused_profile_compact(bnd_packed, rid_small, pos, n_valid, lengths_u32,
                          bin_offset, bin_ends, half, bin_width, lineage,
                          sk_code, q, *, n_contigs, total_bins_pad, n_dense,
                          n_codes, dedup_window, k_steps, window,
                          emit_coverage=True):
    """fused_profile with a compact host->device record format: a bitpacked
    read-boundary mask (1 bit/record) + int16 contig ids (int32 past 32767
    contigs) + int32 positions — ~6.1 B/record instead of 12; the int32
    record arrays are reconstructed on device (_unpack_read_groups)."""
    n_pad = pos.shape[0]
    read_id = _unpack_read_groups(bnd_packed, n_pad, n_valid)
    return _fused_core(read_id, rid_small.astype(jnp.int32), pos,
                       lengths_u32, bin_offset, bin_ends, half, bin_width,
                       lineage, sk_code, q, n_contigs=n_contigs,
                       total_bins_pad=total_bins_pad, n_dense=n_dense,
                       n_codes=n_codes, dedup_window=dedup_window,
                       k_steps=k_steps, window=window,
                       emit_coverage=emit_coverage)


@partial(jax.jit, static_argnames=("n_contigs", "total_bins_pad", "n_dense",
                                   "n_codes", "dedup_window", "k_steps",
                                   "window", "emit_coverage"))
def fused_profile_compact2(bnd_packed, rid_small, lbin, n_valid, lengths_u32,
                           bin_offset, bin_ends, half, bin_width, lineage,
                           sk_code, q, *, n_contigs, total_bins_pad, n_dense,
                           n_codes, dedup_window, k_steps, window,
                           emit_coverage=True):
    """fused_profile over the v2 compact transfer: bitpacked read
    boundaries + int16 contig ids + uint16 HOST-COMPUTED bin indices
    (~4.1 B/record vs ~6.1 for v1).  The center/bin math is exact integer
    work the host does in one vectorized pass; shipping the bin instead of
    the position cuts the host->device bytes by a third."""
    n_pad = lbin.shape[0]
    read_id = _unpack_read_groups(bnd_packed, n_pad, n_valid)
    rid = rid_small.astype(jnp.int32)
    t_gbin = (bin_offset[jnp.clip(rid, 0, n_contigs - 1)]
              + lbin.astype(jnp.int32))
    return _fused_core(read_id, rid, None, lengths_u32, bin_offset,
                       bin_ends, half, bin_width, lineage, sk_code, q,
                       n_contigs=n_contigs, total_bins_pad=total_bins_pad,
                       n_dense=n_dense, n_codes=n_codes,
                       dedup_window=dedup_window, k_steps=k_steps,
                       window=window,
                       emit_coverage=emit_coverage, t_gbin=t_gbin)


@partial(jax.jit, static_argnames=("n_contigs", "total_bins_pad", "n_dense",
                                   "n_codes", "dedup_window", "k_steps",
                                   "window", "emit_coverage"))
def fused_profile_pieces(bnds, rids, lbins, n_valids, lengths_u32,
                         bin_offset, bin_ends, half, bin_width, lineage,
                         sk_code, q, *, n_contigs, total_bins_pad, n_dense,
                         n_codes, dedup_window, k_steps, window,
                         emit_coverage=True):
    """One fused dispatch over K equally-padded v2 pieces that were
    uploaded individually WHILE the file was still decoding (the overlap
    path): pieces concatenate on device, per-piece valid prefixes become
    interspersed read_id == -1 padding (safe for every segment reduction:
    reads never span pieces, so pads only sit between reads)."""
    K = len(lbins)
    n_s = lbins[0].shape[0]
    n_pad = n_s * K
    bits = (jnp.concatenate(bnds)[:, None]
            >> jnp.arange(8, dtype=jnp.uint8)[None, :]) & 1
    gid = _cumsum_1d(bits.astype(jnp.int32).reshape(-1)) - 1
    idx = jax.lax.iota(jnp.int32, n_pad)
    piece = idx // n_s
    valid = (idx - piece * n_s) < n_valids[piece]
    read_id = jnp.where(valid, gid, -1)
    rid = jnp.concatenate(rids).astype(jnp.int32)
    lbin = jnp.concatenate(lbins).astype(jnp.int32)
    t_gbin = bin_offset[jnp.clip(rid, 0, n_contigs - 1)] + lbin
    return _fused_core(read_id, rid, None, lengths_u32, bin_offset,
                       bin_ends, half, bin_width, lineage, sk_code, q,
                       n_contigs=n_contigs, total_bins_pad=total_bins_pad,
                       n_dense=n_dense, n_codes=n_codes,
                       dedup_window=dedup_window, k_steps=k_steps,
                       window=window,
                       emit_coverage=emit_coverage, t_gbin=t_gbin)


@partial(jax.jit, donate_argnums=(0, 1, 2),
         static_argnames=("n_contigs", "total_bins_pad", "k_steps", "window"))
def piece_pass_a_acc(cov, uniq_cov, uniq_matches, bnd_packed, rid_small,
                     lbin, n_valid, lengths_u32, bin_offset, half, bin_width,
                     *, n_contigs, total_bins_pad, k_steps, window):
    """Pass A over ONE v2 piece, accumulated into donated histogram
    buffers — enqueued while the file is still decoding, so the pass-A
    device work AND the piece H2D transfers hide behind the decode.  The
    piece's record-level intermediates (read_id, rid, t_gbin, nondup) stay
    on device for pieces_pass_b_final.  (k_steps, window) is the PIECE's
    own segment plan (from its boundary bits); the final pass B uses the
    whole-file plan."""
    n_s = lbin.shape[0]
    read_id = _unpack_read_groups(bnd_packed, n_s, n_valid)
    rid = rid_small.astype(jnp.int32)
    t_gbin = (bin_offset[jnp.clip(rid, 0, n_contigs - 1)]
              + lbin.astype(jnp.int32))
    a = _pass_a_local(read_id, rid, None, lengths_u32, bin_offset, half,
                      bin_width, n_contigs=n_contigs,
                      total_bins_pad=total_bins_pad, dedup_window=0,
                      k_steps=k_steps, window=window,
                      t_gbin=t_gbin)
    return (cov + a["cov"], uniq_cov + a["uniq_cov"],
            uniq_matches + a["uniq_matches"], read_id, rid, a["t_gbin"],
            a["nondup"])


@partial(jax.jit, static_argnames=("n_contigs", "total_bins_pad", "n_dense",
                                   "n_codes", "k_steps", "window",
                                   "emit_coverage"))
def pieces_pass_b_final(cov, uniq_cov, uniq_matches, read_ids, rids, t_gbins,
                        nondups, gid_offsets, bin_offset, bin_ends, lineage,
                        sk_code, q, *, n_contigs, total_bins_pad, n_dense,
                        n_codes, k_steps, window,
                        emit_coverage=True):
    """Cutoffs + pass B over the per-piece pass-A intermediates (the tail
    of the overlap path's split dispatch).  Per-piece read ids become
    globally unique via gid_offsets (reads never span pieces); -1 pads
    stay -1."""
    parts = [jnp.where(r >= 0, r + gid_offsets[i], jnp.int32(-1))
             for i, r in enumerate(read_ids)]
    read_id = jnp.concatenate(parts)
    rid = jnp.concatenate(rids)
    t_gbin = jnp.concatenate(t_gbins)
    nondup = jnp.concatenate(nondups)
    return _core_after_a(cov, uniq_cov, uniq_matches, read_id, rid, t_gbin,
                         nondup, bin_offset, bin_ends, lineage, sk_code, q,
                         n_contigs=n_contigs, total_bins_pad=total_bins_pad,
                         n_dense=n_dense, n_codes=n_codes, k_steps=k_steps,
                         window=window,
                         emit_coverage=emit_coverage)


def pack_records_compact2(read_id, rid, pos, n_pad, n_contigs, lengths_u32,
                          half, bin_width):
    """v2 compact transfer encode: (bitpacked boundaries uint8[n_pad/8],
    rid int16|int32, HOST-COMPUTED local bin uint16, n_valid).  The bin is
    the reference's exact center binning (uint32 wrap, slimm.hpp:200-201)
    done in one vectorized numpy pass.  Callers must check that every
    contig's bin count fits uint16 (max nbins <= 65535)."""
    n = len(read_id)
    bits = np.zeros(n_pad, np.uint8)
    if n:
        bits[0] = 1
        np.not_equal(read_id[1:], read_id[:-1], out=bits[1:n].view(bool))
    bnd = np.packbits(bits, bitorder="little")
    if n_contigs <= np.iinfo(np.uint8).max:
        rdt = np.uint8
    elif n_contigs <= np.iinfo(np.int16).max:
        rdt = np.int16
    else:
        rdt = np.int32
    rid_p = np.zeros(n_pad, rdt)
    rid_p[:n] = rid
    bin_p = np.zeros(n_pad, np.uint16)
    if n:
        rid_c = np.clip(np.asarray(rid), 0, n_contigs - 1)
        center = np.minimum(
            np.asarray(pos).astype(np.uint32) + np.uint32(half),
            np.asarray(lengths_u32)[rid_c])
        bin_p[:n] = (center // np.uint32(bin_width)).astype(np.uint16)
    return bnd, rid_p, bin_p, np.int32(n)


def pack_records_compact(read_id, rid, pos, n_pad, n_contigs):
    """Host-side compact transfer encode: (bitpacked boundary uint8[n_pad/8],
    rid int16|int32 [n_pad], pos int32[n_pad], n_valid).  read_id/rid/pos
    are the grouped (ascending read id) record arrays; n_pad must be a
    multiple of 2048 (_bucket guarantees this; _cumsum_1d needs 1024)."""
    n = len(read_id)
    bits = np.zeros(n_pad, np.uint8)
    if n:
        bits[0] = 1
        np.not_equal(read_id[1:], read_id[:-1], out=bits[1:n].view(bool))
    bnd = np.packbits(bits, bitorder="little")
    rdt = np.int16 if n_contigs <= np.iinfo(np.int16).max else np.int32
    rid_p = np.zeros(n_pad, rdt)
    rid_p[:n] = rid
    pos_p = np.zeros(n_pad, np.int32)
    pos_p[:n] = pos
    return bnd, rid_p, pos_p, np.int32(n)


def unpack_stats(packed_np, n_contigs, n_dense):
    """Host-side view of the fused `packed` vector."""
    C = n_contigs
    s = packed_np
    scal = s[6 * C:6 * C + _N_SCALARS]
    return dict(
        reads_count=s[0:C], uniq_reads_count=s[C:2 * C],
        nz_cov=s[2 * C:3 * C], nz_uniq=s[3 * C:4 * C],
        uniq_reads_count2=s[4 * C:5 * C], valid=s[5 * C:6 * C].astype(bool),
        uniq_matches=int(scal[0]), uniq_matches2=int(scal[1]),
        cc=np.int32(scal[2]).view(np.float32),
        ucc=np.int32(scal[3]).view(np.float32),
        taxon_counts=s[6 * C + _N_SCALARS:6 * C + _N_SCALARS + n_dense])


def plan_from_max_run(max_run: int):
    """(k_steps, window) for the segment reductions given the longest
    equal-read run.  Kept separate from seg_plan so multi-host runs can
    agree on ONE plan from the allgathered global max_run (the plan is a
    static jit argument — every process must compile the same program)."""
    if max_run - 1 <= MAX_WINDOW:
        window = max(1, max_run - 1)
        k_steps = 2
    else:
        window = 0
        k_steps = max(2, int(np.ceil(np.log2(max(max_run, 2)))))
        k_steps = ((k_steps + 1) // 2) * 2   # bucket to even (recompiles)
    return k_steps, window


def seg_plan(read_id):
    """Host-side plan for the segment reductions: (max_run, k_steps,
    window) from the grouped read-id array."""
    read_id = np.asarray(read_id)
    if len(read_id):
        bnd = np.flatnonzero(np.r_[True, read_id[1:] != read_id[:-1], True])
        max_run = int(np.diff(bnd).max())
    else:
        max_run = 1
    k_steps, window = plan_from_max_run(max_run)
    return max_run, k_steps, window


# ---------------------------------------------------------------------------
# host orchestration
# ---------------------------------------------------------------------------


@dataclass
class EngineResult:
    state: ProfileState
    dense: DenseTaxonomy


def profile_arrays(options: ProfileOptions, db: SlimmDatabase,
                   contig_names, contig_lengths,
                   read_id, rid, pos, n_reads: int, hits_count: int,
                   avg_read_length: int,
                   engine: EngineOptions | None = None,
                   sharded_runner=None, deduped: bool = True,
                   max_targets: int = 0) -> ProfileState:
    """Profile decoded record arrays (the device path).

    read_id/rid/pos: grouped by read id.  With deduped=True (native decoder
    contract) there is one entry per distinct (read, contig) with the first
    hit's position; with deduped=False raw multi-hit records are fine and
    the first-hit-wins rule runs on device.  Fills the same ProfileState as
    the scalar oracle; report generation and propagation are shared
    (slimm_jax.state).  `sharded_runner`, when given, runs the fused pass
    data-parallel over a device mesh (slimm_jax.parallel) with exact
    integer psum merges.
    """
    engine = engine or EngineOptions()
    timer = PhaseTimer(enabled=engine.phase_log)
    st = ProfileState(options=options, ac__taxid=db.ac__taxid,
                      taxid__name=db.taxid__name)
    st.avg_read_length = avg_read_length
    if options.bin_width == 0:
        options.bin_width = avg_read_length

    timer.start("Intializing coverages for all reference genome ... ")
    st.init_contigs(contig_names, contig_lengths, options.bin_width)
    dense = tensorize(db, contig_names)
    n_contigs = len(st.accessions)
    total_bins = int(st.nbins.sum())
    total_bins_pad = -(-total_bins // 1024) * 1024  # _cumsum_1d row multiple
    timer.lap()

    st.hits_count = hits_count
    if hits_count == 0:
        print("[WARNING] No mapped reads found in BAM file!", file=sys.stderr)
        return st
    st.matches_count = n_reads

    timer.start("Analysing alignments, reads and references ....... ")
    # device contract: records grouped by read id (ascending); decoders
    # guarantee this, but arbitrary callers may not
    read_id = np.asarray(read_id)
    if max_targets > 0 and deduped:
        # native grouped decode: run length known, ordering guaranteed —
        # skip the O(N) host scans
        max_run = max_targets
        k_steps, window = plan_from_max_run(max_run)
    else:
        if len(read_id) and not np.all(read_id[:-1] <= read_id[1:]):
            order = np.argsort(read_id, kind="stable")
            read_id = read_id[order]
            rid = np.asarray(rid)[order]
            pos = np.asarray(pos)[order]
        max_run, k_steps, window = seg_plan(read_id)

    def sync(mr):
        # multi-host: the plan is a static jit argument — agree on the
        # global max run so every process compiles the same program
        if sharded_runner is not None and hasattr(sharded_runner,
                                                  "sync_max_run"):
            mr = int(sharded_runner.sync_max_run(mr))
        return mr

    max_run = sync(max_run)
    k_steps, window = plan_from_max_run(max_run)
    if deduped:
        dedup_window = 0
    elif max_run - 1 <= MAX_WINDOW:
        dedup_window = max(1, max_run - 1)
    else:
        # pathological duplicate span: host first-hit dedup (grouped +
        # ascending read ids by this point), then no device dedup needed
        key = read_id.astype(np.int64) * n_contigs + np.asarray(rid)
        _, first = np.unique(key, return_index=True)
        first.sort()
        read_id = read_id[first]
        rid = np.asarray(rid)[first]
        pos = np.asarray(pos)[first]
        max_run, k_steps, window = seg_plan(read_id)
        max_run = sync(max_run)
        k_steps, window = plan_from_max_run(max_run)
        dedup_window = 0
    n_pad = _bucket(len(read_id), engine.batch_pad)
    lengths_u32 = st.lengths.astype(np.uint32)
    bin_offset = st.bin_offset.astype(np.int32)
    bin_ends = (st.bin_offset + st.nbins).astype(np.int32)
    half = np.int32(avg_read_length // 2)
    bw = np.int32(options.bin_width)
    q = np.float32(options.cov_cut_off)

    kw = dict(n_contigs=n_contigs, total_bins_pad=total_bins_pad,
              n_dense=dense.n_dense, n_codes=dense.n_pair_codes,
              dedup_window=dedup_window, k_steps=k_steps, window=window)
    if sharded_runner is not None:
        def pad(a, fill):
            out = np.full(n_pad, fill, np.int32)
            out[:len(a)] = a
            return out

        out = sharded_runner.fused(pad(read_id, -1), pad(rid, 0),
                                   pad(pos, 0), lengths_u32,
                                   bin_offset, bin_ends, half, bw,
                                   dense.lineage, dense.sk_code, q,
                                   emit_coverage=engine.fetch_coverage, **kw)
    else:
        if int(st.nbins.max()) <= V2_MAX_BIN:
            # v2: host-computed uint16 bins, ~4.1 B/record transferred
            bnd, rid_p, bin_p, n_valid = pack_records_compact2(
                read_id, rid, pos, n_pad, n_contigs, lengths_u32, half, bw)
            out = fused_profile_compact2(
                bnd, rid_p, bin_p, n_valid, jnp.asarray(lengths_u32),
                jnp.asarray(bin_offset), jnp.asarray(bin_ends), half, bw,
                jnp.asarray(dense.lineage), jnp.asarray(dense.sk_code), q,
                emit_coverage=engine.fetch_coverage, **kw)
        else:
            bnd, rid_p, pos_p, n_valid = pack_records_compact(
                read_id, rid, pos, n_pad, n_contigs)
            out = fused_profile_compact(
                bnd, rid_p, pos_p, n_valid, jnp.asarray(lengths_u32),
                jnp.asarray(bin_offset), jnp.asarray(bin_ends), half, bw,
                jnp.asarray(dense.lineage), jnp.asarray(dense.sk_code), q,
                emit_coverage=engine.fetch_coverage, **kw)

    _finalize_state(st, out, dense, total_bins, engine, options, timer)
    return st


def _finalize_state(st, out, dense, total_bins, engine, options, timer):
    """Fill a ProfileState from the fused dispatch outputs (host tail
    shared by the single-file and batched paths).  `out` values may be
    device arrays or numpy views (batched path)."""
    n_contigs = len(st.accessions)
    stats = unpack_stats(np.asarray(out["packed"]), n_contigs, dense.n_dense)
    st.reads_count = stats["reads_count"].astype(np.int64)
    st.uniq_reads_count = stats["uniq_reads_count"].astype(np.int64)
    st._nz_cache["cov"] = stats["nz_cov"].astype(np.int64)
    st._nz_cache["uniq_cov"] = stats["nz_uniq"].astype(np.int64)
    st.uniq_matches_count = stats["uniq_matches"]
    st.uniq_hits_count = st.uniq_matches_count  # identical by construction
    if engine.fetch_coverage:
        st.cov = np.asarray(out["cov"])[:total_bins].astype(np.uint32)
        st.uniq_cov = np.asarray(out["uniq_cov"])[:total_bins].astype(
            np.uint32)
    else:
        # drop the zero-filled placeholders so bin-level access without a
        # fetch fails loudly instead of reading silent zeros
        st.cov = st.uniq_cov = st.uniq_cov2 = None
    st.compute_abundances()
    timer.lap()

    if options.min_reads == 0:
        options.min_reads = 1 + (st.matches_count - 1) // 10000

    timer.start("Filtering unlikely sequences ..................... ")
    # host recompute for the failure counters + memoized report cutoffs;
    # bit-identical to the device mask (same integer stats, same f32
    # sequential algorithm).  Pass B already filtered with the DEVICE mask,
    # so a mismatch means the LCA counts are wrong: fail, do not report.
    valid = st.compute_valid_refs()
    if not np.array_equal(np.asarray(valid), stats["valid"]):
        raise RuntimeError("device/host validity mask mismatch: "
                           f"{int(np.sum(np.asarray(valid) != stats['valid']))}"
                           " contigs differ")
    timer.lap()

    timer.start("Assigning reads to Least Common Ancestor (LCA) ... ")
    st.uniq_reads_count2 = stats["uniq_reads_count2"].astype(np.int64)
    if engine.fetch_coverage:
        st.uniq_cov2 = np.asarray(out["uniq_cov2"])[:total_bins].astype(
            np.uint32)
    st.uniq_matches_count2 = stats["uniq_matches2"]

    # dense LCA counts + children pairs → taxid dicts (host finalize)
    counts = stats["taxon_counts"]
    for d in np.flatnonzero(counts > 0).tolist():
        tid = int(dense.dense_to_tid[d])
        st.taxon_id__read_count[tid] = (
            st.taxon_id__read_count.get(tid, 0) + int(counts[d]))
    base = 6 * n_contigs + _N_SCALARS + dense.n_dense
    packed_np = np.asarray(out["packed"])
    # bitpacked (contig x level-code) presence: either streamed separately
    # (pair_bits uint8) or riding as int32 words in the packed tail.
    # Code < 8 = the read's first agreeing lineage level L → the lca is
    # lineage[r][L]; code 8+k = no level agreed → the lca is the k-th
    # distinct superkingdom id (see _pass_b_local).
    if "pair_bits" in out:
        pbytes = np.asarray(out["pair_bits"])
    else:
        pbytes = np.ascontiguousarray(packed_np[base:]).view(np.uint8)
    n_codes = dense.n_pair_codes
    pres = np.unpackbits(pbytes, bitorder="little")
    nz = np.flatnonzero(pres[:n_contigs * n_codes])
    r = (nz // n_codes).astype(np.int64)
    code = (nz % n_codes).astype(np.int64)
    lvl = code < 8
    lca_d = np.where(lvl, dense.lineage[r, np.minimum(code, 7)],
                     dense.sk_dense[np.maximum(code, 8) - 8]
                     if len(dense.sk_dense) else 0)
    pairs = np.unique(np.stack([lca_d, r], axis=1), axis=0)
    # grouped set fills: pairs is lexicographically sorted, so one slice
    # per distinct LCA (the per-pair add loop cost ~5x this at full-RefSeq
    # pair counts)
    d_vals, starts = np.unique(pairs[:, 0], return_index=True)
    bounds = np.append(starts, len(pairs))
    tids = dense.dense_to_tid[d_vals]
    col = pairs[:, 1]
    for i, tid in enumerate(tids.tolist()):
        st.taxon_id__children.setdefault(int(tid), set()).update(
            col[starts[i]:bounds[i + 1]].tolist())

    st.propagate_counts()
    timer.lap()
    return st


def open_alignment_file(path: str, engine: EngineOptions | None = None):
    """Native C++ decoder when built (slimm_jax/io/native.py), else the
    pure-Python reference decoder — identical array contract."""
    engine = engine or EngineOptions()
    if engine.use_native:
        from ..io import native
        if native.available():
            return native.NativeAlignmentFile(
                path, hash_names=engine.hash_read_names)
    from ..io import AlignmentFile
    return AlignmentFile(path)


def profile_file(options: ProfileOptions, db: SlimmDatabase, path: str,
                 engine: EngineOptions | None = None,
                 sharded_runner=None) -> ProfileState:
    """Decode one SAM/BAM file and profile it on device.

    Large qname-grouped files take the overlap path: the native stream
    decoder emits read-complete pieces that upload to the device WHILE
    the rest of the file is still decoding, and a single fused dispatch
    concatenates them on device — decode and the host->device transfer
    overlap, and the dispatch count stays at one."""
    engine = engine or EngineOptions()
    if (sharded_runner is None and engine.use_native
            and engine.overlap_min_bytes > 0):
        import os
        try:
            big = os.path.getsize(path) >= engine.overlap_min_bytes
        except OSError:
            big = False
        if big:
            st = _profile_file_overlap(options, db, path, engine)
            if st is not None:
                return st
    af = open_alignment_file(path, engine)
    batch = af.load()
    return profile_arrays(
        options, db, af.contig_names, af.contig_lengths,
        batch.read_id.astype(np.int32), batch.rid, batch.pos,
        batch.n_reads, batch.hits_count, batch.avg_read_length,
        engine=engine, sharded_runner=sharded_runner,
        max_targets=batch.max_targets)


def _bucket_pieces(k):
    b = 1
    while b < k:
        b = b * 2 if b < 32 else b + 16
    return b


def _profile_file_overlap(options: ProfileOptions, db: SlimmDatabase,
                          path: str, engine: EngineOptions
                          ) -> ProfileState | None:
    """Whole-file profile with decode/upload overlap (see profile_file).
    Returns None when the overlap path does not apply (no native stream,
    bins past uint16, mid-stream loss of read grouping) — callers fall
    back.  Coordinate-sorted input works: the C++ stream decoder regroups
    at EOF and the pieces upload then, still one fused dispatch and no
    second decode."""
    from ..io import native
    if not native.available():
        return None
    try:
        sr = native.NativeStreamReader(path,
                                       hash_names=engine.hash_read_names)
    except ValueError:
        return None

    st, dense, geom = _stream_init(options, db, sr)
    n_contigs = geom["n_contigs"]
    if int(st.nbins.max() if len(st.nbins) else 0) > V2_MAX_BIN:
        return None  # v2 bins don't fit; standard path re-decodes
    timer = PhaseTimer(enabled=engine.phase_log)
    timer.start("Analysing alignments, reads and references ....... ")

    cap = engine.overlap_piece_targets
    # Scale the piece size so the (bucketed) piece count stays <= ~64: the
    # final dispatch takes K 4-tuples of tensors, and a many-hundred-arg
    # jit costs compile time and arg marshaling.  The bytes-per-record
    # divisor deliberately over-estimates the record count (SAM text lines
    # run ~150-400 B; BGZF-compressed BAM can compress to ~25-60 B/record,
    # hence the smaller divisor), so the piece budget errs toward fewer,
    # larger pieces.  Only auto-scale at the DEFAULT cap: an explicit
    # engine.overlap_piece_targets is an exact user knob (tests rely on
    # tiny caps to force multi-piece coverage on toy files).
    if cap == type(engine)().overlap_piece_targets:
        import os
        bpr = 25 if path.lower().endswith((".bam", ".gz", ".bgzf")) else 100
        try:
            est_targets = os.path.getsize(path) // bpr + 1
        except OSError:
            est_targets = 0
        cap = max(cap, -(-est_targets // 56))
    n_s = -(-cap // 2048) * 2048
    d_len = jnp.asarray(geom["lengths_u32"])
    d_off = jnp.asarray(geom["bin_offset"])
    d_ends = jnp.asarray(geom["bin_ends"])
    d_lin = jnp.asarray(dense.lineage)
    total_bins_pad = geom["total_bins_pad"]

    # Synchronous piece loop: the C++ decoder is ALREADY pipelined (its
    # tokenizer thread runs ahead behind a bounded queue), so next_piece_v2
    # blocks only on the consumer half; the async upload + per-piece pass-A
    # dispatch below overlap the tokenizer's decode of the next window.  A
    # python-side producer thread here measured SLOWER on the 2-vCPU host
    # (three compute threads contending for two cores).  The v2 transfer
    # encode (boundary bitpack, rid cast, center binning) happens INSIDE
    # the C++ take — per-record numpy work on the host serialized against
    # the decode and cost ~0.1 s/M records before it moved native.
    #
    # Split dispatch: pass A runs per piece into donated accumulators
    # DURING the decode (which both starts the piece's H2D transfer
    # immediately and hides the pass-A device time); after EOF one final
    # dispatch computes cutoffs + pass B over the retained device
    # intermediates.  Exposed device time after the last piece is pass B
    # only (~half the pipeline) instead of the whole fused program.
    if n_contigs <= np.iinfo(np.uint8).max:
        rid_dtype = np.uint8
    elif n_contigs <= np.iinfo(np.int16).max:
        rid_dtype = np.int16
    else:
        rid_dtype = np.int32
    acc = None
    pieces = []            # per-piece (read_id, rid, t_gbin, nondup) on device
    gid_offs = [0]         # cumulative read counts → global read ids
    n_reads_cum = 0
    while True:
        try:
            piece = sr.next_piece_v2(n_s, n_s, geom["lengths_u32"],
                                     geom["half"], geom["bin_width"],
                                     rid_dtype, with_plan=True)
        except ValueError as e:
            if "not qname-grouped" in str(e):
                return None
            raise
        except OverflowError:
            return None  # one read's targets exceed a piece; fall back
        if piece is None:
            break
        # per-piece segment plan + read count computed inside the C++ take
        bnd, rid_p, bin_p, nv, p_reads, p_maxrun = piece
        pk, pw = plan_from_max_run(max(int(p_maxrun), 1))
        if acc is None:
            acc = (jnp.zeros(total_bins_pad, jnp.int32),
                   jnp.zeros(total_bins_pad, jnp.int32), jnp.int32(0))
        cov, ucov, um, p_read, p_rid, p_gbin, p_nd = piece_pass_a_acc(
            acc[0], acc[1], acc[2], jnp.asarray(bnd), jnp.asarray(rid_p),
            jnp.asarray(bin_p), jnp.int32(int(nv)), d_len, d_off,
            geom["half"], geom["bin_width"], n_contigs=n_contigs,
            total_bins_pad=total_bins_pad, k_steps=pk, window=pw)
        acc = (cov, ucov, um)
        pieces.append((p_read, p_rid, p_gbin, p_nd))
        n_reads_cum += int(p_reads)
        gid_offs.append(n_reads_cum)

    n_reads, hits_count, _ = sr.totals()
    warn = sr.warning()
    if warn:
        print(f"[WARNING] {path}: {warn}", file=sys.stderr)
    st.hits_count = hits_count
    st.matches_count = n_reads
    if hits_count == 0:
        print("[WARNING] No mapped reads found in BAM file!", file=sys.stderr)
        timer.lap()
        return st

    k_steps, window = plan_from_max_run(max(sr.max_targets, 1))
    K = _bucket_pieces(len(pieces))
    if K > len(pieces):  # pad with one shared all-empty piece
        z_read = jnp.asarray(np.full(n_s, -1, np.int32))
        z_i32 = jnp.asarray(np.zeros(n_s, np.int32))
        z_nd = jnp.asarray(np.zeros(n_s, bool))
        while len(pieces) < K:
            pieces.append((z_read, z_i32, z_i32, z_nd))
            gid_offs.append(n_reads_cum)

    out = pieces_pass_b_final(
        acc[0], acc[1], acc[2],
        tuple(p[0] for p in pieces), tuple(p[1] for p in pieces),
        tuple(p[2] for p in pieces), tuple(p[3] for p in pieces),
        jnp.asarray(np.asarray(gid_offs[:K], np.int32)),
        d_off, d_ends, d_lin, jnp.asarray(dense.sk_code), geom["q"],
        n_contigs=n_contigs, total_bins_pad=total_bins_pad,
        n_dense=dense.n_dense, n_codes=dense.n_pair_codes,
        k_steps=k_steps, window=window,
        emit_coverage=engine.fetch_coverage)
    _finalize_state(st, out, dense, geom["total_bins"], engine, options,
                    timer)
    return st


# ---------------------------------------------------------------------------
# chunk-streaming execution (bounded device memory + decode/dispatch overlap)
# ---------------------------------------------------------------------------
#
# For files whose record arrays exceed device memory (BASELINE.md's 1B-read
# streamed config), the engine runs the SAME two-pass dataflow chunked:
# the native stream decoder emits read-complete target chunks while a
# background thread decodes ahead; pass A accumulates the coverage
# histograms on device across chunk dispatches (async dispatch overlaps the
# next chunk's decode); the cutoffs/validity mask are computed once from the
# accumulated histograms; pass B re-walks the host-cached chunks (12 B per
# target) against the mask.  Device memory is O(histograms + one chunk);
# host memory is O(targets + name dictionary); raw file bytes never resident.


@partial(jax.jit, donate_argnums=(0, 1, 2),
         static_argnames=("n_contigs", "total_bins_pad", "k_steps",
                          "window", "pos_is_bin"))
def _pass_a_chunk_jit(cov, uniq_cov, um, bnd, rid_small, pos, n_valid,
                      lengths_u32, bin_offset, half, bin_width, *, n_contigs,
                      total_bins_pad, k_steps, window, pos_is_bin=False):
    read_id = _unpack_read_groups(bnd, pos.shape[0], n_valid)
    rid = rid_small.astype(jnp.int32)
    t_gbin = None
    if pos_is_bin:  # v2 chunks carry the decoder-computed local bin
        t_gbin = (bin_offset[jnp.clip(rid, 0, n_contigs - 1)]
                  + pos.astype(jnp.int32))
    a = _pass_a_local(read_id, rid, pos,
                      lengths_u32, bin_offset, half,
                      bin_width, n_contigs=n_contigs,
                      total_bins_pad=total_bins_pad, dedup_window=0,
                      k_steps=k_steps, window=window,
                      t_gbin=t_gbin)
    return cov + a["cov"], uniq_cov + a["uniq_cov"], um + a["uniq_matches"]


@partial(jax.jit, static_argnames=("emit",))
def _pack_stream_jit(rc, urc, nzc, nzu, u2_acc, valid, um, um2, cc, ucc,
                     taxon, pair_acc, bin_offset, bin_ends, *, emit):
    """Assemble the streaming finalize outputs into the standard packed
    int32 vector (unpack_stats layout + bitpacked pair tail) on device —
    the whole host finalize then needs ONE fetch round trip."""
    u2 = (_boundary_sums(u2_acc, bin_offset, bin_ends) if emit else u2_acc)
    scalars = jnp.stack([
        um, um2,
        jax.lax.bitcast_convert_type(cc, jnp.int32),
        jax.lax.bitcast_convert_type(ucc, jnp.int32),
        jnp.int32(0), jnp.int32(0), jnp.int32(0), jnp.int32(0)])
    return jnp.concatenate([rc, urc, nzc, nzu, u2,
                            valid.astype(jnp.int32), scalars, taxon,
                            _pack_bits_words(pair_acc > 0)])


@jax.jit
def _cutoffs_jit(cov, uniq_cov, bin_offset, bin_ends, q):
    rc, nzc = _contig_sums_nz(cov, bin_offset, bin_ends)
    urc, nzu = _contig_sums_nz(uniq_cov, bin_offset, bin_ends)
    nbins_f = (bin_ends - bin_offset).astype(jnp.float32)
    covp = nzc.astype(jnp.float32) / nbins_f
    ucovp = nzu.astype(jnp.float32) / nbins_f
    sel = urc > 0
    use_cut = q < jnp.float32(1.0)
    cc_q, ucc_q = _quantile2_dev(covp, ucovp, sel, q)
    cc = jnp.where(use_cut, cc_q, jnp.float32(0.0))
    ucc = jnp.where(use_cut, ucc_q, jnp.float32(0.0))
    valid = (rc > 0) & (covp >= cc) & (ucovp >= ucc)
    return rc, urc, nzc, nzu, valid, cc, ucc


@partial(jax.jit, donate_argnums=(0, 1, 2, 3),
         static_argnames=("n_contigs", "total_bins_pad", "n_dense",
                          "n_codes", "k_steps", "window",
                          "emit_coverage", "pos_is_bin"))
def _pass_b_chunk_jit(u2_acc, taxon, um2, pair_acc, bnd, rid_small, pos,
                      n_valid, valid_mask, lineage, sk_code,
                      lengths_u32, bin_offset, half, bin_width, *,
                      n_contigs, total_bins_pad, n_dense, n_codes, k_steps,
                      window, emit_coverage, pos_is_bin=False):
    read_id = _unpack_read_groups(bnd, pos.shape[0], n_valid)
    rid = rid_small.astype(jnp.int32)
    rid_c = jnp.clip(rid, 0, n_contigs - 1)
    if pos_is_bin:  # v2 chunks carry the decoder-computed local bin
        t_gbin = bin_offset[rid_c] + pos.astype(jnp.int32)
    else:
        center = jnp.minimum(
            pos.astype(jnp.uint32) + half.astype(jnp.uint32),
            lengths_u32[rid_c])
        t_gbin = bin_offset[rid_c] + (
            center // bin_width.astype(jnp.uint32)).astype(jnp.int32)
    nondup = read_id >= 0  # native stream decoder pre-dedups
    b = _pass_b_local(read_id, rid, t_gbin, nondup, valid_mask, lineage,
                      sk_code, n_contigs=n_contigs,
                      total_bins_pad=total_bins_pad, n_dense=n_dense,
                      n_codes=n_codes, k_steps=k_steps, window=window,
                      emit_coverage=emit_coverage)
    if emit_coverage:
        u2_acc = u2_acc + b["uniq_cov2"]
    else:
        u2_acc = u2_acc + b["u2_counts"]
    # (contig x code) pair presence accumulates on device (tiny domain);
    # ONE small bitpacked fetch at finalize — no per-chunk pair fetches
    return (u2_acc, taxon + b["taxon_counts"], um2 + b["uniq_matches2"],
            pair_acc | b["pair_levels"])


def _open_stream(path: str, engine: EngineOptions, chunk_targets: int):
    """Open a native chunk stream with a decode-ahead producer thread.

    Returns (stream_reader, next_chunk, thread) or None when streaming is
    unavailable (native decoder not built, or the file fails to open as a
    stream).  next_chunk() re-raises producer-side decode errors."""
    import queue
    import threading

    from ..io import native
    if not native.available():
        return None
    try:
        sr = native.NativeStreamReader(path,
                                       hash_names=engine.hash_read_names)
    except ValueError:
        return None

    feed: queue.Queue = queue.Queue(maxsize=2)

    def producer():
        try:
            while True:
                c = sr.next_chunk(chunk_targets)
                feed.put(("ok", c))
                if c is None:
                    return
        except Exception as e:  # non-grouped input or decode error
            feed.put(("err", e))

    th = threading.Thread(target=producer, daemon=True)
    th.start()

    def next_chunk():
        kind, val = feed.get()
        if kind == "err":
            raise val
        return val

    return sr, next_chunk, th


def _stream_init(options: ProfileOptions, db: SlimmDatabase, sr,
                 avg: int | None = None):
    """Shared streaming setup: ProfileState + dense taxonomy + the numpy
    bin-table geometry both the single-device and the sharded streaming
    drivers dispatch against.  `avg` overrides the stream's sampled
    average read length (multi-host: process 0's sample is broadcast so
    every process agrees on bin_width)."""
    st = ProfileState(options=options, ac__taxid=db.ac__taxid,
                      taxid__name=db.taxid__name)
    if avg is None:
        avg = sr.avg_read_length
    st.avg_read_length = avg
    if options.bin_width == 0:
        options.bin_width = avg
    st.init_contigs(sr.contig_names, sr.contig_lengths, options.bin_width)
    dense = tensorize(db, sr.contig_names)
    total_bins = int(st.nbins.sum())
    geom = dict(
        n_contigs=len(st.accessions),
        total_bins=total_bins,
        total_bins_pad=-(-total_bins // 1024) * 1024,
        lengths_u32=st.lengths.astype(np.uint32),
        bin_offset=st.bin_offset.astype(np.int32),
        bin_ends=(st.bin_offset + st.nbins).astype(np.int32),
        half=np.int32(avg // 2),
        bin_width=np.int32(options.bin_width),
        q=np.float32(options.cov_cut_off))
    return st, dense, geom


def profile_file_streaming(options: ProfileOptions, db: SlimmDatabase,
                           path: str, engine: EngineOptions | None = None,
                           chunk_targets: int | None = None,
                           sharded_runner=None) -> ProfileState:
    """Chunk-streaming profile of one (qname-grouped) SAM/BAM file.

    Bit-identical to profile_file: the same dataflow, chunked.
    Coordinate-sorted input streams too (the C++ decoder regroups at EOF;
    host memory O(targets) for that case).  Falls back to the whole-file
    path when the native decoder is unavailable or the input loses read
    grouping mid-stream after chunks shipped.  With a
    `sharded_runner` (ShardedRunner / MultiHostRunner) each chunk is routed
    over the data mesh and the coverage state may additionally be
    bin-sharded over the model axis — same integer psums as the whole-file
    sharded path, so results stay bit-identical (BASELINE.md's streamed
    multi-host config)."""
    engine = engine or EngineOptions()
    chunk_targets = chunk_targets or engine.stream_chunk or (4 << 20)
    if sharded_runner is not None:
        from ..parallel.streaming import profile_file_streaming_sharded
        return profile_file_streaming_sharded(options, db, path,
                                              sharded_runner, engine=engine,
                                              chunk_targets=chunk_targets)
    timer = PhaseTimer(enabled=engine.phase_log)

    timer.start("Streaming alignment chunks ....................... ")
    from ..io import native
    if not native.available():
        return profile_file(options, db, path, engine=engine)
    bw0 = options.bin_width
    try:
        sr = native.NativeStreamReader(path,
                                       hash_names=engine.hash_read_names)
    except ValueError:
        return profile_file(options, db, path, engine=engine)

    st, dense, geom = _stream_init(options, db, sr)
    n_contigs = geom["n_contigs"]
    total_bins = geom["total_bins"]
    total_bins_pad = geom["total_bins_pad"]
    lengths_u32 = jnp.asarray(geom["lengths_u32"])
    bin_offset = jnp.asarray(geom["bin_offset"])
    bin_ends = jnp.asarray(geom["bin_ends"])
    half = geom["half"]
    bw = geom["bin_width"]
    q = geom["q"]
    lineage = jnp.asarray(dense.lineage)

    # v2 chunk mode: the C++ decoder emits pieces pre-encoded in the v2
    # compact format (bitpacked boundaries + small rid + uint16 local bin
    # ~ 4.1 B/record vs the v1 host pack's 6.1) whenever every contig's
    # bin count fits uint16; its tokenizer thread runs ahead, so no python
    # producer thread is needed.  v1 (host pack_records_compact, int32
    # positions) remains for bin tables past uint16.
    pos_is_bin = (int(st.nbins.max() if len(st.nbins) else 0)
                  <= V2_MAX_BIN)
    if pos_is_bin:
        n_pad = _bucket(chunk_targets, engine.batch_pad)  # one piece shape
        if n_contigs <= np.iinfo(np.uint8).max:
            rid_dtype = np.uint8
        elif n_contigs <= np.iinfo(np.int16).max:
            rid_dtype = np.int16
        else:
            rid_dtype = np.int32
        th = None

        def next_packed():
            piece = sr.next_piece_v2(n_pad, n_pad, geom["lengths_u32"],
                                     half, bw, rid_dtype, with_plan=True)
            if piece is None:
                return None
            # the PIECE's own longest read (sr.max_targets is final only
            # at EOF; reads never span pieces)
            bnd, rid_p, bin_p, n_valid, _, p_maxrun = piece
            k_steps, window = plan_from_max_run(max(int(p_maxrun), 1))
            return bnd, rid_p, bin_p, n_valid, k_steps, window
    else:
        # decode-ahead producer thread (the v1 host pack is python work
        # that would otherwise serialize against the dispatch enqueues)
        import queue
        import threading

        feed: queue.Queue = queue.Queue(maxsize=2)

        def _producer():
            try:
                while True:
                    c = sr.next_chunk(chunk_targets)
                    feed.put(("ok", c))
                    if c is None:
                        return
            except Exception as e:  # non-grouped input or decode error
                feed.put(("err", e))

        th = threading.Thread(target=_producer, daemon=True)
        th.start()

        def next_packed():
            kind, val = feed.get()
            if kind == "err":
                raise val
            if val is None:
                return None
            read_id, rid, pos = val
            np_pad = _bucket(len(read_id), engine.batch_pad)
            bnd, rid_p, pos_p, n_valid = pack_records_compact(
                read_id, rid, pos, np_pad, n_contigs)
            _, k_steps, window = seg_plan(read_id)
            return bnd, rid_p, pos_p, n_valid, k_steps, window

    # ---- pass A: accumulate coverage across chunk dispatches ----
    # Uploaded chunk arrays stay device-resident within a byte budget so
    # pass B skips the host->device re-transfer; past the budget, pass B
    # re-uploads from the host copies.
    chunks: list = []
    budget = engine.stream_device_cache_bytes
    cov = jnp.zeros(total_bins_pad, jnp.int32)
    uniq_cov = jnp.zeros(total_bins_pad, jnp.int32)
    um = jnp.int32(0)
    while True:
        try:
            packed = next_packed()
        except ValueError as e:
            if "not qname-grouped" in str(e):
                if th is not None:
                    th.join()
                options.bin_width = bw0  # undo _stream_init's auto default
                return profile_file(options, db, path, engine=engine)
            raise
        except OverflowError:  # one read's targets exceed a v2 piece
            options.bin_width = bw0
            return profile_file(options, db, path, engine=engine)
        if packed is None:
            break
        bnd, rid_p, pos_p, n_valid, k_steps, window = packed
        d = (jnp.asarray(bnd), jnp.asarray(rid_p), jnp.asarray(pos_p))
        nbytes = bnd.nbytes + rid_p.nbytes + pos_p.nbytes
        if budget >= nbytes:
            budget -= nbytes
            chunks.append((d, n_valid, k_steps, window))
        else:
            chunks.append(((bnd, rid_p, pos_p), n_valid, k_steps, window))
        cov, uniq_cov, um = _pass_a_chunk_jit(
            cov, uniq_cov, um, d[0], d[1], d[2], n_valid,
            lengths_u32, bin_offset, half, bw,
            n_contigs=n_contigs, total_bins_pad=total_bins_pad,
            k_steps=k_steps, window=window,
            pos_is_bin=pos_is_bin)
        # decode of chunk k+1 overlaps the dispatch just enqueued
    if th is not None:
        th.join()
    n_reads, hits_count, _ = sr.totals()
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
    rc, urc, nzc, nzu, valid, cc, ucc = _cutoffs_jit(cov, uniq_cov,
                                                     bin_offset, bin_ends, q)

    # ---- pass B over the cached chunks (device-resident or host copies) ----
    emit = engine.fetch_coverage
    u2_acc = jnp.zeros(total_bins_pad if emit else n_contigs, jnp.int32)
    taxon = jnp.zeros(dense.n_dense, jnp.int32)
    um2 = jnp.int32(0)
    # (contig x code) pair presence accumulates on device across chunks;
    # ONE small bitpacked fetch at finalize, bounded host memory
    pair_dom = -(-(n_contigs * dense.n_pair_codes) // 1024) * 1024
    pair_acc = jnp.zeros(pair_dom, jnp.int8)
    sk_code = jnp.asarray(dense.sk_code)
    for (r, i, p), n_valid, k_steps, window in chunks:
        u2_acc, taxon, um2, pair_acc = _pass_b_chunk_jit(
            u2_acc, taxon, um2, pair_acc, jnp.asarray(r), jnp.asarray(i),
            jnp.asarray(p), n_valid, valid, lineage, sk_code, lengths_u32,
            bin_offset, half, bw, n_contigs=n_contigs,
            total_bins_pad=total_bins_pad, n_dense=dense.n_dense,
            n_codes=dense.n_pair_codes, k_steps=k_steps, window=window,
            emit_coverage=emit, pos_is_bin=pos_is_bin)
    timer.lap()

    # ---- host finalize via the shared packed layout: everything the
    # abundance path needs is assembled on DEVICE into the standard
    # packed vector (pair bits in the tail) and comes back in ONE fetch ----
    packed = np.asarray(_pack_stream_jit(
        rc, urc, nzc, nzu, u2_acc, valid, um, um2, cc, ucc, taxon,
        pair_acc, bin_offset, bin_ends, emit=emit))
    out = dict(packed=packed)
    if emit:
        out.update(cov=cov, uniq_cov=uniq_cov, uniq_cov2=u2_acc)
    t2 = PhaseTimer(enabled=engine.phase_log)
    t2.start("Filtering + LCA (fused above) ..................... ")
    _finalize_state(st, out, dense, total_bins, engine, options, t2)
    return st


# ---------------------------------------------------------------------------
# batched multi-file dispatch (directory mode)
# ---------------------------------------------------------------------------
#
# Directory mode stacks K files into ONE jit'ed lax.scan over the file
# axis (each dispatch and fetch has a fixed host cost): one dispatch, one
# packed fetch for all K files.  Per-file bin tables (bin_width defaults to
# each file's average read length, slimm.hpp:412-413) ride along as dynamic
# (K, C) inputs; only the padded sizes and the segment plan are static
# (maxima over the group).


@partial(jax.jit, static_argnames=("n_contigs", "total_bins_pad", "n_dense",
                                   "n_codes", "dedup_window", "k_steps",
                                   "window", "emit_coverage"))
def fused_profile_batch(read_id, rid, pos, lengths_u32, bin_offset, bin_ends,
                        half, bin_width, lineage, sk_code, q, *, n_contigs,
                        total_bins_pad, n_dense, n_codes, dedup_window,
                        k_steps, window,
                        emit_coverage=True):
    """read_id/rid/pos: (K, N); bin_offset/bin_ends: (K, C); half/bin_width:
    (K,).  Returns the fused outputs stacked over the leading file axis."""

    def body(carry, xs):
        r, i, p, off, ends, hf, bw = xs
        out = _fused_core(r, i, p, lengths_u32, off, ends, hf, bw,
                          lineage, sk_code, q, n_contigs=n_contigs,
                          total_bins_pad=total_bins_pad, n_dense=n_dense,
                          n_codes=n_codes, dedup_window=dedup_window,
                          k_steps=k_steps, window=window,
                          emit_coverage=emit_coverage)
        ys = (out["packed"],)   # pair bits ride in the packed tail
        if emit_coverage:
            ys = ys + (out["cov"], out["uniq_cov"], out["uniq_cov2"])
        return carry, ys

    _, ys = jax.lax.scan(body, jnp.int32(0),
                         (read_id, rid, pos, bin_offset, bin_ends,
                          half, bin_width))
    out = dict(packed=ys[0])
    if emit_coverage:
        out.update(cov=ys[1], uniq_cov=ys[2], uniq_cov2=ys[3])
    return out


def profile_files_batched(options: ProfileOptions, db: SlimmDatabase,
                          paths: list, engine: EngineOptions | None = None
                          ) -> list:
    """Profile a group of SAM/BAM files sharing one reference (identical
    BAM headers) in a single device dispatch.  Returns [(path,
    ProfileState | None); None marks an empty file (warned, like the
    reference's zero-mapped-reads path].  Falls back to per-file dispatch
    when headers differ."""
    import copy as _copy

    engine = engine or EngineOptions()
    decoded = []
    for path in paths:
        af = open_alignment_file(path, engine)
        decoded.append((path, af, af.load()))
    names0 = list(decoded[0][1].contig_names)
    lengths0 = np.asarray(decoded[0][1].contig_lengths)
    same_ref = all(
        list(af.contig_names) == names0
        and np.array_equal(np.asarray(af.contig_lengths), lengths0)
        for _, af, _ in decoded[1:])
    if not same_ref:
        # per-file dispatch; profile_arrays mutates options (bin_width,
        # min_reads defaults), so each file gets its own copy — the
        # reference CLI deep-copies per file for the same reason
        return [(path,
                 profile_file(_copy.deepcopy(options), db, path,
                              engine=engine))
                for path, _, _ in decoded]

    timer = PhaseTimer(enabled=engine.phase_log)
    timer.start("Intializing coverages for all reference genome ... ")
    dense = tensorize(db, names0)
    n_contigs = len(names0)
    lengths = lengths0

    preps = []      # (path, st, options_k, arrays...) per non-empty file
    empties = []
    for path, af, batch in decoded:
        opts_k = _copy.deepcopy(options)
        st = ProfileState(options=opts_k, ac__taxid=db.ac__taxid,
                          taxid__name=db.taxid__name)
        st.avg_read_length = batch.avg_read_length
        if opts_k.bin_width == 0:
            opts_k.bin_width = batch.avg_read_length
        st.init_contigs(names0, lengths, opts_k.bin_width)
        st.hits_count = batch.hits_count
        st.matches_count = batch.n_reads
        if batch.hits_count == 0:
            empties.append((path, st))
            continue
        preps.append((path, st, opts_k, batch))
    timer.lap()

    if not preps:
        for _, st in empties:
            print("[WARNING] No mapped reads found in BAM file!",
                  file=sys.stderr)
        return [(p, s) for p, s in empties]

    timer.start("Analysing alignments, reads and references ....... ")
    plans = [seg_plan(b.read_id) for _, _, _, b in preps]
    max_run = max(p[0] for p in plans)
    if max_run - 1 <= MAX_WINDOW:
        window = max(1, max_run - 1)
        k_steps = 2
    else:
        window = 0
        k_steps = max(2, int(np.ceil(np.log2(max(max_run, 2)))))
        k_steps = ((k_steps + 1) // 2) * 2
    K = len(preps)
    n_pad = _bucket(max(len(b.read_id) for _, _, _, b in preps),
                    engine.batch_pad)
    total_bins = max(int(s.nbins.sum()) for _, s, _, _ in preps)
    total_bins_pad = -(-total_bins // 1024) * 1024

    read_id = np.full((K, n_pad), -1, np.int32)
    rid = np.zeros((K, n_pad), np.int32)
    pos = np.zeros((K, n_pad), np.int32)
    bin_offset = np.zeros((K, n_contigs), np.int32)
    bin_ends = np.zeros((K, n_contigs), np.int32)
    half = np.zeros(K, np.int32)
    bwidth = np.zeros(K, np.int32)
    for k, (path, st, opts_k, b) in enumerate(preps):
        n = len(b.read_id)
        read_id[k, :n] = b.read_id
        rid[k, :n] = b.rid
        pos[k, :n] = b.pos
        bin_offset[k] = st.bin_offset.astype(np.int32)
        bin_ends[k] = (st.bin_offset + st.nbins).astype(np.int32)
        half[k] = b.avg_read_length // 2
        bwidth[k] = opts_k.bin_width

    out = fused_profile_batch(
        jnp.asarray(read_id), jnp.asarray(rid), jnp.asarray(pos),
        jnp.asarray(lengths.astype(np.uint32)), jnp.asarray(bin_offset),
        jnp.asarray(bin_ends), jnp.asarray(half), jnp.asarray(bwidth),
        jnp.asarray(dense.lineage), jnp.asarray(dense.sk_code),
        np.float32(options.cov_cut_off),
        n_contigs=n_contigs, total_bins_pad=total_bins_pad,
        n_dense=dense.n_dense, n_codes=dense.n_pair_codes, dedup_window=0,
        k_steps=k_steps, window=window,
        emit_coverage=engine.fetch_coverage)
    packed = np.asarray(out["packed"])          # one fetch for all files
    cov = np.asarray(out["cov"]) if engine.fetch_coverage else None
    uniq_cov = np.asarray(out["uniq_cov"]) if engine.fetch_coverage else None
    uniq_cov2 = (np.asarray(out["uniq_cov2"]) if engine.fetch_coverage
                 else None)
    timer.lap()

    results = {path: st for path, st in empties}
    for _, st in empties:
        print("[WARNING] No mapped reads found in BAM file!", file=sys.stderr)
    for k, (path, st, opts_k, b) in enumerate(preps):
        tb = int(st.nbins.sum())
        out_k = dict(packed=packed[k])
        if engine.fetch_coverage:
            out_k.update(cov=cov[k], uniq_cov=uniq_cov[k],
                         uniq_cov2=uniq_cov2[k])
        t2 = PhaseTimer(enabled=False)
        t2.start("")
        _finalize_state(st, out_k, dense, tb, engine, opts_k, t2)
        results[path] = st
    return [(path, results[path]) for path, _, _ in decoded]
