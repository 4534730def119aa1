#!/usr/bin/env python
"""Benchmark: alignment records/sec/chip through coverage + LCA.

Runs the fused device pipeline (dedup + binning + coverage + quantile
cutoffs + filter + LCA in ONE jit dispatch per file) on a synthetic
metagenomic workload and compares against the single-core C++ baseline
(native/slimm_native.cpp stpu_baseline_profile — a faithful implementation
of the reference's hash-map hot loops on the same pre-decoded arrays).

Orchestration: the parent process never touches jax; each phase (core /
e2e / large / stream) runs in its OWN subprocess under a timeout, one at
a time (one process holds the device), and the headline JSON line is
printed and flushed the moment the core phase lands.  A final merged
line follows when the remaining phases finish; partial results are also
written to BENCH_partial.json after every phase.

Env knobs: SLIMM_BENCH_RECORDS (default 8_000_000), SLIMM_BENCH_CONTIGS (50),
SLIMM_BENCH_REPS (5), SLIMM_BENCH_E2E_RECORDS (default 4_000_000 — a ~1.3 GB
SAM + a BAM variant of the same records; the full CLI data path),
SLIMM_BENCH_LARGE_RECORDS (default 10_000_000 over a 1000-contig DB — the
BASELINE.md 1k-genome config; 0 skips), SLIMM_BENCH_STREAM_RECORDS
(default 32_000_000 chunk-streamed from a ~10 GB SAM incl. decode — the
BASELINE.md streamed config; 0 skips; the parent scales it down when the
time budget runs short), SLIMM_BENCH_STREAM_REPS (measured streamed runs,
default 2), SLIMM_BENCH_STREAM_LOG=1 (engine phase logs on the streamed
runs), SLIMM_BENCH_BAM=1 (adds the BAM e2e variant),
SLIMM_BENCH_BUDGET (total seconds, default 1500), SLIMM_BENCH_PHASE
(internal: run one phase as a child).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np


def make_workload(n_records, n_contigs, seed=0):
    """Synthetic alignments: ~90% unique reads, ~10% multi-mapped (2-3 hits),
    contig lengths 0.5-2 Mbp, read length 150.  Records grouped per read
    (mapper output order — the decoder contract)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(500_000, 2_000_000, n_contigs).astype(np.uint32)
    avg_read_len = 150
    n_reads_target = int(n_records / 1.15)
    weights = rng.dirichlet(np.ones(n_contigs) * 0.3)
    read_contig = rng.choice(n_contigs, n_reads_target, p=weights)
    multi = rng.random(n_reads_target) < 0.10
    extra_counts = np.where(multi, rng.integers(1, 3, n_reads_target), 0)

    rows = [np.stack([np.arange(n_reads_target, dtype=np.int64), read_contig],
                     axis=1)]
    for k in range(2):
        sel = np.flatnonzero(extra_counts > k)
        partner = rng.integers(0, n_contigs, len(sel))
        rows.append(np.stack([sel, partner], axis=1))
    pairs = np.concatenate(rows)
    order = np.argsort(pairs[:, 0], kind="stable")  # records grouped per read
    pairs = pairs[order]
    read_id = pairs[:, 0].astype(np.int32)
    rid = pairs[:, 1].astype(np.int32)
    pos = (rng.random(len(rid))
           * (lengths[rid] - avg_read_len)).astype(np.int32)
    lineage = np.zeros((n_contigs, 8), np.int32)
    # dense taxonomy: species-ish groups of 5 contigs sharing upper ranks
    base = 1
    for c in range(n_contigs):
        lineage[c, 0] = base + c
        for lvl in range(1, 8):
            lineage[c, lvl] = base + n_contigs + (c // (5 * lvl)) + 1000 * lvl
    n_dense = int(lineage.max()) + 1
    sk_dense = np.unique(lineage[:, 7]).astype(np.int32)
    sk_code = np.searchsorted(sk_dense, lineage[:, 7]).astype(np.int32)
    return dict(read_id=read_id, rid=rid, pos=pos,
                n_reads=n_reads_target, lengths=lengths, lineage=lineage,
                n_dense=n_dense, avg_read_len=avg_read_len,
                sk_code=sk_code, n_codes=8 + len(sk_dense))


def make_bench_db(w, n_contigs):
    from slimm_jax.database import SlimmDatabase

    db = SlimmDatabase()
    names, _ = bench_names(n_contigs)
    for c in range(n_contigs):
        db.ac__taxid[names[c]] = w["lineage"][c].tolist()
        for lvl in range(8):
            tid = int(w["lineage"][c, lvl])
            db.taxid__name.setdefault(tid, (lvl, f"taxon{tid}"))
    return db


def bench_device(w, reps, measure_h2d=True):
    import jax.numpy as jnp

    from slimm_jax.engine.pipeline import _bucket, fused_profile, seg_plan

    n_contigs = len(w["lengths"])
    bin_width = np.int32(w["avg_read_len"])
    nbins = w["lengths"] // np.uint32(bin_width) + 1
    bin_offset = np.concatenate([[0], np.cumsum(nbins)[:-1]]).astype(np.int32)
    bin_ends = (bin_offset + nbins).astype(np.int32)
    total_bins_pad = -(-int(nbins.sum()) // 1024) * 1024

    _, k_steps, window = seg_plan(w["read_id"])
    n_pad = _bucket(len(w["read_id"]))
    read_id = np.full(n_pad, -1, np.int32)
    read_id[:len(w["read_id"])] = w["read_id"]
    rid = np.zeros(n_pad, np.int32)
    rid[:len(w["rid"])] = w["rid"]
    pos = np.zeros(n_pad, np.int32)
    pos[:len(w["pos"])] = w["pos"]

    d_read = jnp.asarray(read_id)
    d_rid = jnp.asarray(rid)
    d_pos = jnp.asarray(pos)
    d_len = jnp.asarray(w["lengths"])
    d_off = jnp.asarray(bin_offset)
    d_ends = jnp.asarray(bin_ends)
    d_lineage = jnp.asarray(w["lineage"])
    d_sk = jnp.asarray(w["sk_code"])
    half = np.int32(w["avg_read_len"] // 2)
    q = np.float32(0.95)

    def step():
        # emit_coverage=False matches the default CLI profile run (-ro/-co
        # off): per-contig integers only, no bin-resolution fetch
        out = fused_profile(
            d_read, d_rid, d_pos, d_len, d_off, d_ends, half, bin_width,
            d_lineage, d_sk, q, n_contigs=n_contigs,
            total_bins_pad=total_bins_pad,
            n_dense=w["n_dense"], n_codes=w["n_codes"],
            dedup_window=max(1, window),
            k_steps=k_steps, window=window, emit_coverage=False)
        return out["packed"]

    np.asarray(step())  # warmup/compile
    # single-file latency: dispatch + blocking fetch of the packed stats
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        np.asarray(step())
        lat.append(time.perf_counter() - t0)
    latency = float(np.median(lat))
    # sustained: pipeline `reps` files back-to-back (async dispatch overlaps
    # the round-trip latency with the next file's compute)
    t0 = time.perf_counter()
    outs = [step() for _ in range(reps)]
    for o in outs:
        np.asarray(o)
    sustained = (time.perf_counter() - t0) / reps

    if not measure_h2d:
        # skip the compact-transfer variant (one more large-program
        # compile at 10M+ bin domains)
        return latency, sustained, 0.0

    # cold per-file latency INCLUDING the host->device record transfer in
    # the compact v2 format (the real per-file dispatch path: the device
    # arrays above are uploaded once outside the timed loop, which hides
    # the transfer)
    from slimm_jax.engine.pipeline import (fused_profile_compact2,
                                           pack_records_compact2)

    def step_cold():
        bnd, rid_p, bin_p, n_valid = pack_records_compact2(
            w["read_id"], w["rid"], w["pos"], n_pad, n_contigs,
            w["lengths"], half, bin_width)
        out = fused_profile_compact2(
            jnp.asarray(bnd), jnp.asarray(rid_p), jnp.asarray(bin_p),
            n_valid, d_len, d_off, d_ends, half, bin_width, d_lineage,
            d_sk, q, n_contigs=n_contigs, total_bins_pad=total_bins_pad,
            n_dense=w["n_dense"], n_codes=w["n_codes"], dedup_window=0,
            k_steps=k_steps, window=window, emit_coverage=False)
        return np.asarray(out["packed"])

    step_cold()  # warmup/compile (the raw workload is pre-dedup'd enough:
    # dedup_window=0 changes counters, not the transfer+dispatch cost)
    lat_cold = []
    for _ in range(min(reps, 3)):
        t0 = time.perf_counter()
        step_cold()
        lat_cold.append(time.perf_counter() - t0)
    return latency, sustained, float(np.median(lat_cold))


def bench_baseline(w, reps):
    from slimm_jax.io import native

    times = []
    for _ in range(max(5, reps)):  # median-of-5: the 2-vCPU host is noisy
        secs, counters = native.baseline_profile(
            w["read_id"], w["rid"], w["pos"], w["n_reads"], w["lengths"],
            w["lineage"], w["avg_read_len"], w["avg_read_len"])
        times.append(secs)
    return float(np.median(times)), counters


def bench_names(n_contigs):
    """Zero-padded contig names: every record line is then fixed-width,
    which is what lets write_bench_sam build the file with vectorized
    numpy byte fills instead of 32M python f-strings (the f-string loop
    took 430 s for the 10.3 GB streamed-config file — it was the reason
    the round-4 driver bench timed out)."""
    cw = max(1, len(str(n_contigs - 1)))
    return [f"ctg{c:0{cw}d}" for c in range(n_contigs)], cw


def write_bench_sam(path, w, n_contigs, block=1 << 20):
    """Write the workload as a SAM file (vectorized fixed-width lines;
    numeric fields zero-padded — leading zeros parse identically)."""
    names, cw = bench_names(n_contigs)
    rl = 4 * (w["avg_read_len"] // 4)
    seq = b"ACGT" * (w["avg_read_len"] // 4)
    qual = b"I" * rl
    rid, pos, read = w["rid"], w["pos"], w["read_id"]
    rw = max(1, len(str(int(read.max()) if len(read) else 0)))
    pw = max(1, len(str(int(w["lengths"].max()) + 1)))
    cig = f"{w['avg_read_len']}M".encode()
    row = (b"r" + b"0" * rw + b"\t0\tctg" + b"0" * cw + b"\t" + b"0" * pw
           + b"\t60\t" + cig + b"\t*\t0\t0\t" + seq + b"\t" + qual + b"\n")
    o_read = 1
    o_rid = o_read + rw + 6          # "\t0\tctg"
    o_pos = o_rid + cw + 1
    tmpl = np.frombuffer(row, np.uint8)
    # the line buffer is allocated and template-filled ONCE; per block
    # only the digit columns are rewritten (uint32 divmods) and the
    # buffer is handed to write() directly — ~540 MB/s vs 24 MB/s for
    # the per-line f-string loop this replaces
    m = np.empty((min(block, len(rid)) or 1, len(row)), np.uint8)
    m[:] = tmpl

    def put(col, vals, width):
        v = vals.astype(np.uint32)
        for k in range(width):
            np.add(np.uint8(48),
                   ((v // np.uint32(10**k)) % np.uint32(10)).astype(np.uint8),
                   out=m[:len(v), col + width - 1 - k])

    with open(path, "wb", buffering=1 << 22) as f:
        head = "@HD\tVN:1.6\n" + "".join(
            f"@SQ\tSN:{names[c]}\tLN:{int(w['lengths'][c])}\n"
            for c in range(n_contigs))
        f.write(head.encode())
        for lo in range(0, len(rid), block):
            hi = min(lo + block, len(rid))
            n = hi - lo
            put(o_read, read[lo:hi], rw)
            put(o_rid, rid[lo:hi], cw)
            put(o_pos, pos[lo:hi] + 1, pw)
            f.write(m[:n])
    return os.path.getsize(path) / 2**20


def _bgzf_blocks(payload: bytes, out, level=1):
    """BGZF-wrap `payload` into <=64KB deflate blocks appended to file
    `out` (the BAM container format, SAM spec §4.1)."""
    import struct
    import zlib

    STEP = 0xFF00
    for lo in range(0, max(len(payload), 1), STEP):
        chunk = payload[lo:lo + STEP]
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        cdata = co.compress(chunk) + co.flush()
        bsize = len(cdata) + 25 + 1
        out.write(struct.pack("<4BI2BH2B2H", 31, 139, 8, 4, 0, 0, 255,
                              6, 66, 67, 2, bsize - 1))
        out.write(cdata)
        out.write(struct.pack("<II", zlib.crc32(chunk), len(chunk)))


def write_bench_bam(path, w, n_contigs, block=1 << 20):
    """Write the workload as a BAM file (BGZF container, binary records) —
    the e2e decode-floor attack: binary records parse ~4x less text than
    SAM and the BGZF blocks inflate block-parallel across both vCPUs.
    Records are built vectorized with numpy (a python struct loop would
    take minutes at 4M records)."""
    import struct

    names, _ = bench_names(n_contigs)
    rl = 4 * (w["avg_read_len"] // 4)  # the SAM twin's actual seq length
    rid, pos, read = w["rid"], w["pos"], w["read_id"]
    name_len = len(f"r{max(int(read.max()), 0)}")
    # fixed-size record: header(32) + qname(name_len+1) + cigar(4)
    # + seq(ceil(rl/2)) + qual(rl)
    seq_b = (rl + 1) // 2
    rec_size = 36 + name_len + 1 + 4 + seq_b + rl
    with open(path, "wb", buffering=1 << 22) as f:
        hdr_text = "@HD\tVN:1.6\n" + "".join(
            f"@SQ\tSN:{nm}\tLN:{int(w['lengths'][c])}\n"
            for c, nm in enumerate(names))
        head = b"BAM\x01" + struct.pack("<i", len(hdr_text))
        head += hdr_text.encode() + struct.pack("<i", n_contigs)
        for c, nm in enumerate(names):
            head += struct.pack("<i", len(nm) + 1) + nm.encode() + b"\0"
            head += struct.pack("<i", int(w["lengths"][c]))
        _bgzf_blocks(head, f)

        tmpl = np.zeros(rec_size, np.uint8)
        v32 = lambda a: a.view("<i4")  # noqa: E731
        for lo in range(0, len(rid), block):
            hi = min(lo + block, len(rid))
            n = hi - lo
            recs = np.broadcast_to(tmpl, (n, rec_size)).copy()
            head32 = v32(recs[:, :36])
            head32[:, 0] = rec_size - 4                 # block_size
            head32[:, 1] = rid[lo:hi]                   # refID
            head32[:, 2] = pos[lo:hi]                   # POS (0-based)
            # l_read_name | mapq | bin
            head32[:, 3] = (name_len + 1) | (60 << 8)
            head32[:, 4] = 1 | (0 << 16)                # n_cigar | flag=0
            head32[:, 5] = rl                           # l_seq
            head32[:, 6] = -1                           # next_refID
            head32[:, 7] = -1                           # next_pos
            head32[:, 8] = 0                            # tlen
            # qname "r<digits>" zero-padded to fixed width + NUL
            digits = read[lo:hi].astype(np.int64)
            recs[:, 36] = ord("r")
            for k in range(name_len - 1):
                recs[:, 36 + name_len - 1 - k] = (
                    ord("0") + (digits // 10**k) % 10)
            recs[:, 36 + name_len] = 0
            cig = v32(recs[:, 36 + name_len + 1:36 + name_len + 5])
            cig[:, 0] = rl << 4                         # <rl>M
            body = recs[:, 36 + name_len + 5:]
            body[:, :seq_b] = 0x12                      # ACAC... 4-bit
            body[:, seq_b:] = 40                        # qual 'I'
            _bgzf_blocks(recs.tobytes(), f)
        _bgzf_blocks(b"", f)  # EOF marker
    return os.path.getsize(path) / 2**20


# ---------------------------------------------------------------------------
# phases (each runs in its own subprocess; returns a dict of result keys)
# ---------------------------------------------------------------------------


def phase_core():
    n_records = int(os.environ.get("SLIMM_BENCH_RECORDS", 8_000_000))
    n_contigs = int(os.environ.get("SLIMM_BENCH_CONTIGS", 50))
    reps = int(os.environ.get("SLIMM_BENCH_REPS", 5))
    w = make_workload(n_records, n_contigs)
    n = len(w["read_id"])
    base_secs, _ = bench_baseline(w, reps)
    latency_secs, sustained_secs, latency_h2d_secs = bench_device(w, reps)
    dev_rps = n / sustained_secs
    base_rps = n / base_secs
    return {
        "metric": "alignment records/sec/chip through coverage+LCA",
        "value": round(dev_rps),
        "unit": "records/s",
        "vs_baseline": round(dev_rps / base_rps, 2),
        "baseline_records_per_s_cpp_1core": round(base_rps),
        "records": n,
        "device_secs": round(sustained_secs, 4),
        "latency_secs": round(latency_secs, 4),
        "latency_h2d_secs": round(latency_h2d_secs, 4),
        "baseline_secs": round(base_secs, 4),
        "backend": _backend_name(),
    }


def _e2e_overlap(db, path, tmp, reps=3):
    """Best-of-N of the real CLI large-file path (decode overlapped with v2
    piece upload, one fused dispatch) + abundance TSV."""
    import copy

    from slimm_jax.config import EngineOptions, ProfileOptions
    from slimm_jax.engine.pipeline import profile_file
    from slimm_jax.engine.reports import write_abundance

    def one():
        t0 = time.perf_counter()
        st = profile_file(
            copy.deepcopy(ProfileOptions()), db, path,
            engine=EngineOptions(phase_log=False, fetch_coverage=False))
        write_abundance(st, os.path.join(tmp, "out/"), path)
        return st, time.perf_counter() - t0

    one()  # warm the jit cache (one-time compile; the CLI amortizes it)
    runs = [one() for _ in range(max(1, reps))]
    st, secs = min(runs, key=lambda r: r[1])
    return st, secs


def _e2e_baseline(path, w, reps=3):
    """Single-core C++ e2e on the same file: single-thread native decode +
    the reference's hash-map hot loops (slimm.hpp:946-968 unit of work;
    the TSV write is granted — ~ms on both sides)."""
    from slimm_jax.io import native

    base_times = []
    for _ in range(reps):
        b0 = time.perf_counter()
        af = native.NativeAlignmentFile(path, single_thread=True)
        batch = af.load()
        secs, counters = native.baseline_profile(
            batch.read_id.astype(np.int32), batch.rid, batch.pos,
            batch.n_reads, w["lengths"], w["lineage"],
            batch.avg_read_length, batch.avg_read_length)
        base_times.append(time.perf_counter() - b0)
    return float(np.min(base_times)), counters


def phase_e2e():
    """Decode + device + report tail on a real SAM file AND its BAM
    twin (native streaming decoder -> fused dispatch -> abundance TSV),
    the full CLI data path, vs the C++ single-core e2e on the same
    files."""
    import copy
    import tempfile

    from slimm_jax.config import EngineOptions, ProfileOptions
    from slimm_jax.engine.pipeline import open_alignment_file, profile_arrays
    from slimm_jax.engine.reports import write_abundance

    n_records = int(os.environ.get("SLIMM_BENCH_E2E_RECORDS", 4_000_000))
    n_contigs = int(os.environ.get("SLIMM_BENCH_CONTIGS", 50))
    if n_records <= 0:
        return {}
    w = make_workload(n_records, n_contigs, seed=1)
    db = make_bench_db(w, n_contigs)
    tmp = tempfile.mkdtemp(prefix="slimm_bench_")
    sam = os.path.join(tmp, "bench.sam")
    size_mb = write_bench_sam(sam, w, n_contigs)
    os.sync()  # flush writeback before timing (it contends for the 2 vCPUs)
    _mark("e2e SAM written")

    # instrumented split pass (decode / device / report) on the SAM
    def split_pass():
        t0 = time.perf_counter()
        af = open_alignment_file(sam, EngineOptions())
        batch = af.load()
        t1 = time.perf_counter()
        st = profile_arrays(
            copy.deepcopy(ProfileOptions()), db, af.contig_names,
            af.contig_lengths, batch.read_id.astype(np.int32), batch.rid,
            batch.pos, batch.n_reads, batch.hits_count,
            batch.avg_read_length,
            engine=EngineOptions(phase_log=False, fetch_coverage=False))
        t2 = time.perf_counter()
        write_abundance(st, os.path.join(tmp, "out/"), sam)
        t3 = time.perf_counter()
        return st, t0, t1, t2, t3

    split_pass()  # warm
    _mark("e2e split-pass compiled")
    runs = [split_pass() for _ in range(2)]
    st, t0, t1, t2, t3 = min(runs, key=lambda r: r[4] - r[1])
    _mark("e2e split-pass measured")

    stv, overlap_secs = _e2e_overlap(db, sam, tmp, reps=2)
    _mark("e2e overlap measured")
    assert stv.matches_count == st.matches_count
    base_e2e, counters = _e2e_baseline(sam, w)
    _mark("e2e baseline measured")
    assert counters["matches"] == st.matches_count
    os.remove(sam)

    e2e_rps = st.hits_count / min(t3 - t0, overlap_secs)
    base_rps = st.hits_count / base_e2e
    out = {
        "e2e_records": int(st.hits_count),
        "e2e_input_mb": round(size_mb, 1),
        "e2e_decode_secs": round(t1 - t0, 4),
        "e2e_device_secs": round(t2 - t1, 4),
        "e2e_report_secs": round(t3 - t2, 4),
        "e2e_overlap_secs": round(overlap_secs, 4),
        "e2e_records_per_s": round(e2e_rps),
        "baseline_e2e_secs": round(base_e2e, 4),
        "baseline_e2e_records_per_s": round(base_rps),
        "vs_baseline_e2e": round(e2e_rps / base_rps, 2),
    }

    # BAM variant: same records in binary form (opt-in: the measured
    # answer is that BAM decode is BGZF-inflate-bound at ~92% of the
    # 2-core roofline and cannot beat the uncompressed-SAM tokenizer —
    # see README "input formats"; keep the driver bench lean by default)
    if os.environ.get("SLIMM_BENCH_BAM", "") != "1":
        return out
    bam = os.path.join(tmp, "bench.bam")
    bam_mb = write_bench_bam(bam, w, n_contigs)
    _mark("e2e BAM written")
    stb, bam_secs = _e2e_overlap(db, bam, tmp, reps=2)
    _mark("e2e BAM measured")
    assert stb.matches_count == st.matches_count
    bam_base_secs, counters = _e2e_baseline(bam, w, reps=2)
    assert counters["matches"] == st.matches_count
    os.remove(bam)
    bam_rps = stb.hits_count / bam_secs
    bam_base_rps = stb.hits_count / bam_base_secs
    out.update({
        "e2e_bam_input_mb": round(bam_mb, 1),
        "e2e_bam_secs": round(bam_secs, 4),
        "e2e_bam_records_per_s": round(bam_rps),
        "e2e_bam_baseline_secs": round(bam_base_secs, 4),
        "e2e_bam_vs_baseline": round(bam_rps / bam_base_rps, 2),
    })
    return out


def phase_large():
    """BASELINE.md config: ~1k-genome DB x 10M records, whole-file device
    pipeline (bin domain ~12.6M) vs the single-core baseline on the same
    arrays."""
    n_records = int(os.environ.get("SLIMM_BENCH_LARGE_RECORDS", 10_000_000))
    reps = int(os.environ.get("SLIMM_BENCH_REPS", 5))
    if n_records <= 0:
        return {}
    w = make_workload(n_records, 1000, seed=2)
    base_secs, _ = bench_baseline(w, 3)
    latency, sustained, _ = bench_device(w, min(reps, 3), measure_h2d=False)
    n = len(w["read_id"])
    return {
        "large_records": n,
        "large_contigs": 1000,
        "large_device_secs": round(sustained, 4),
        "large_latency_secs": round(latency, 4),
        "large_records_per_s": round(n / sustained),
        "large_baseline_secs": round(base_secs, 4),
        "large_vs_baseline": round(base_secs / sustained, 2),
    }


def phase_stream():
    """BASELINE.md config: chunk-streamed profile of a file bigger than
    any sensible single upload (decode + chunked device passes + reports),
    sustained records/s INCLUDING decode, vs the single-core baseline
    end-to-end on the same file.  Reports a decode-only floor measured on
    the same file right before the streamed runs, so dispatch overhead is
    attributable, and the median of the measured runs with their spread."""
    import copy
    import shutil
    import tempfile

    from slimm_jax.config import EngineOptions, ProfileOptions
    from slimm_jax.engine.pipeline import profile_file_streaming
    from slimm_jax.engine.reports import write_abundance

    n_records = int(os.environ.get("SLIMM_BENCH_STREAM_RECORDS", 32_000_000))
    n_contigs = int(os.environ.get("SLIMM_BENCH_CONTIGS", 50))
    # 3 measured runs: the 2-vCPU host throws occasional 2-3x outlier
    # runs, and a median-of-2 is just their mean
    stream_reps = int(os.environ.get("SLIMM_BENCH_STREAM_REPS", 3))
    if n_records <= 0:
        return {}
    # ~322 B/record of SAM text; skip gracefully when disk is short
    need = n_records * 340
    if shutil.disk_usage(tempfile.gettempdir()).free < need * 1.3:
        return {"stream_skipped": "insufficient disk"}

    w = make_workload(n_records, n_contigs, seed=3)
    db = make_bench_db(w, n_contigs)
    tmp = tempfile.mkdtemp(prefix="slimm_bench_stream_")
    sam = os.path.join(tmp, "stream.sam")
    size_mb = write_bench_sam(sam, w, n_contigs)
    # Flush the ~10 GB of dirty pages NOW: background writeback racing the
    # timed read-back was the dominant run-to-run variance source (2 vCPUs
    # shared between writeback, the decoder threads, and dispatch).
    os.sync()
    _mark(f"stream SAM written ({size_mb:.0f} MB)")

    phase_log = os.environ.get("SLIMM_BENCH_STREAM_LOG", "") == "1"

    def one():
        t0 = time.perf_counter()
        st = profile_file_streaming(
            copy.deepcopy(ProfileOptions()), db, sam,
            engine=EngineOptions(phase_log=phase_log, fetch_coverage=False))
        write_abundance(st, os.path.join(tmp, "out/"), sam)
        return st, time.perf_counter() - t0

    st, warm_secs = one()          # includes one-time jit compile
    _mark(f"stream warm run {warm_secs:.2f}s")
    assert st.hits_count == len(w["read_id"])

    # decode-only floor AFTER the warm run (measured cold it absorbs the
    # first-touch page-fault storm of the fresh 10 GB file and reads 3x
    # high); the streamed runs below are decode-bound, so stream_secs -
    # decode_only attributes the dispatch overhead
    from slimm_jax.io import native
    d0 = time.perf_counter()
    sr = native.NativeStreamReader(sam)
    n_pad = 4 << 20
    while sr.next_piece_v2(n_pad, n_pad, w["lengths"], 75, 150,
                           np.uint8) is not None:
        pass
    decode_only = time.perf_counter() - d0
    del sr
    _mark(f"stream decode-only floor {decode_only:.2f}s")
    times = []
    for _ in range(max(1, stream_reps)):
        st, secs = one()
        times.append(secs)
    secs = float(np.median(times))
    _mark(f"stream measured runs {times}")

    # single-core C++ end-to-end on the same file (decode + hot loops)
    b0 = time.perf_counter()
    af = native.NativeAlignmentFile(sam, single_thread=True)
    batch = af.load()
    bsecs, counters = native.baseline_profile(
        batch.read_id.astype(np.int32), batch.rid, batch.pos,
        batch.n_reads, w["lengths"], w["lineage"],
        batch.avg_read_length, batch.avg_read_length)
    base_e2e = time.perf_counter() - b0
    assert counters["matches"] == st.matches_count
    del batch, af

    os.remove(sam)
    n = int(st.hits_count)
    return {
        "stream_records": n,
        "stream_contigs": n_contigs,
        "stream_input_mb": round(size_mb, 1),
        "stream_secs": round(secs, 3),
        "stream_secs_runs": [round(t, 3) for t in times],
        "stream_decode_only_secs": round(decode_only, 3),
        "stream_records_per_s": round(n / secs),
        "stream_baseline_e2e_secs": round(base_e2e, 3),
        "stream_vs_baseline_e2e": round(base_e2e / secs, 2),
    }


PHASES = {"core": phase_core, "e2e": phase_e2e, "large": phase_large,
          "stream": phase_stream}

_T0 = time.perf_counter()


def _mark(what):
    print(f"[bench] +{time.perf_counter() - _T0:.1f}s {what}",
          file=sys.stderr, flush=True)


def _backend_name():
    try:
        import jax
        return f"{jax.default_backend()}:{jax.devices()[0].device_kind}"
    except Exception:
        return "unknown"


# ---------------------------------------------------------------------------
# parent orchestrator (no jax; phases in subprocesses with timeouts)
# ---------------------------------------------------------------------------


def _run_phase(name, timeout, env_extra=None):
    """Run one phase in a child process; returns (dict, error_str)."""
    env = dict(os.environ)
    env["SLIMM_BENCH_PHASE"] = name
    env.update(env_extra or {})
    try:
        p = subprocess.run([sys.executable, os.path.abspath(__file__)],
                           env=env, timeout=timeout,
                           stdout=subprocess.PIPE, stderr=sys.stderr)
    except subprocess.TimeoutExpired:
        return None, f"timeout({timeout:.0f}s)"
    if p.returncode != 0:
        return None, f"rc={p.returncode}"
    for line in reversed(p.stdout.decode(errors="replace").splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line), None
            except json.JSONDecodeError:
                pass
    return None, "no JSON output"


def main():
    if os.environ.get("SLIMM_BENCH_PHASE"):
        # child mode: one phase, one JSON line
        from slimm_jax.utils.compile_cache import enable_compilation_cache
        enable_compilation_cache()
        result = PHASES[os.environ["SLIMM_BENCH_PHASE"]]()
        print(json.dumps(result), flush=True)
        return

    budget = float(os.environ.get("SLIMM_BENCH_BUDGET", 1500))
    t_start = time.perf_counter()

    # children killed by a phase timeout leak their tmp dirs (up to a
    # 10 GB stream SAM each) — sweep stale ones before starting
    import glob
    import shutil
    import tempfile
    for d in glob.glob(os.path.join(tempfile.gettempdir(), "slimm_bench_*")):
        shutil.rmtree(d, ignore_errors=True)

    def remaining():
        return budget - (time.perf_counter() - t_start)

    result = {"metric": "alignment records/sec/chip through coverage+LCA",
              "value": 0, "unit": "records/s", "vs_baseline": 0.0}
    partial_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "BENCH_partial.json")

    def checkpoint():
        try:
            with open(partial_path, "w") as f:
                json.dump(result, f)
        except OSError:
            pass

    def attempt(name, timeout, env_extra=None):
        if remaining() < 45:
            return None, "budget exhausted"
        t = min(timeout, max(remaining() - 20, 45))
        print(f"[bench] phase {name} (timeout {t:.0f}s, "
              f"{remaining():.0f}s left)", file=sys.stderr, flush=True)
        out, err = _run_phase(name, t, env_extra)
        if out is None:
            print(f"[bench] phase {name} failed: {err}", file=sys.stderr,
                  flush=True)
        return out, err

    # 1) core: the headline — print + flush the moment it lands
    core, err = attempt("core", 240)
    if core is not None:
        result.update(core)
        print(json.dumps(result), flush=True)
    else:
        result["core_error"] = err
        print(f"[bench] CORE PHASE LOST: {err}", file=sys.stderr, flush=True)
    checkpoint()

    # 2) e2e (full data path; BAM variant via SLIMM_BENCH_BAM=1)
    out, err = attempt("e2e", 250)
    result.update(out or {"e2e_error": err})
    checkpoint()

    # 3) large-DB config
    out, err = attempt("large", 210)
    result.update(out or {"large_error": err})
    checkpoint()

    # 4) streamed config — scale the file to the remaining budget instead
    # of risking the whole artifact on a 10 GB write
    n_stream = int(os.environ.get("SLIMM_BENCH_STREAM_RECORDS", 32_000_000))
    if remaining() < 150:
        n_stream = 0
    elif remaining() < 240:
        n_stream = min(n_stream, 8_000_000)
    elif remaining() < 330:
        n_stream = min(n_stream, 16_000_000)
    if n_stream > 0:
        out, err = attempt(
            "stream", min(max(remaining() - 20, 45), 700),
            env_extra={"SLIMM_BENCH_STREAM_RECORDS": str(n_stream)})
        result.update(out or {"stream_error": err})
    else:
        result["stream_skipped"] = "insufficient time budget"
    checkpoint()

    result["bench_total_secs"] = round(time.perf_counter() - t_start, 1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
