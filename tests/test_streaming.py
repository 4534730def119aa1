"""Chunk-streaming decode + profile.

The streaming path must be BIT-identical to the whole-file fused dispatch:
same dataflow, chunked, with pass A accumulating histograms across chunk
dispatches and pass B re-walking host-cached chunks against the validity
mask.  Tiny chunk sizes force many chunks so read-boundary cuts, per-chunk
plans, and accumulator donation are all exercised.
"""

import copy

import numpy as np
import pytest

from slimm_jax.config import EngineOptions, ProfileOptions
from slimm_jax.engine import profile_file
from slimm_jax.engine.pipeline import profile_file_streaming
from slimm_jax.io import native

from tests.test_engine import assert_states_equal, run_both
from tests.toy import build_toy_dataset, build_toy_db, write_bam, write_sam


@pytest.fixture(scope="session", autouse=True)
def ensure_native_built():
    # available() builds the library from native/ on first use
    if not native.available():
        pytest.skip("native toolchain unavailable")


def test_stream_reader_matches_whole_file(toy_dir, tmp_path):
    # big enough to chunk: the stream open pre-samples the first 100k
    # records for the reference-exact average read length (bin_width
    # derives from it, slimm.hpp:412-413), so chunked delivery starts
    # after that prefix
    ds = build_toy_dataset(str(tmp_path), n_extra=115000, seed=5)
    for path in (ds.sam_path, write_bam(str(tmp_path), ds.records)):
        whole = native.NativeAlignmentFile(path).load()
        sr = native.NativeStreamReader(path)
        parts = []
        while True:
            c = sr.next_chunk(512)
            if c is None:
                break
            parts.append(c)
        assert len(parts) > 1  # actually chunked
        read_id = np.concatenate([c[0] for c in parts])
        # read-boundary cut: no read id spans two chunks
        for a, b in zip(parts[:-1], parts[1:]):
            assert a[0][-1] != b[0][0]
        np.testing.assert_array_equal(read_id,
                                      whole.read_id.astype(np.int32))
        np.testing.assert_array_equal(
            np.concatenate([c[1] for c in parts]), whole.rid)
        assert sr.totals()[:2] == (whole.n_reads, whole.hits_count)
        assert sr.avg_read_length == whole.avg_read_length


def test_overlap_whole_file_matches_standard(tmp_path):
    # whole-file overlap path (decode || H2D upload, ONE fused dispatch
    # over uploaded v2 pieces) must be bit-identical to the standard
    # whole-file decode-then-dispatch path
    ds = build_toy_dataset(str(tmp_path), n_extra=4000, seed=13)
    db = build_toy_db(ds)
    st_std = profile_file(
        ProfileOptions(), copy.deepcopy(db), ds.sam_path,
        engine=EngineOptions(phase_log=False, overlap_min_bytes=0))
    st_ovl = profile_file(
        ProfileOptions(), copy.deepcopy(db), ds.sam_path,
        engine=EngineOptions(phase_log=False, overlap_min_bytes=1,
                             overlap_piece_targets=2048))
    # several pieces + piece-count padding were exercised
    assert_states_equal(st_std, st_ovl)


def test_streaming_avg_read_length_matches_whole(toy_dir, tmp_path):
    # varying read lengths: the sampled average (hence the auto
    # bin_width) must equal the whole-file decode even when the first
    # stream chunk covers only a prefix of the 100k-record sample window
    records = []
    for k in range(3000):
        ln = 60 if k < 500 else 180   # short head, long tail
        records.append((f"v{k}", 0, k % 5, (37 * k) % 2000, ln))
    sam = write_sam(str(tmp_path), records, name="varlen.sam")
    whole = native.NativeAlignmentFile(sam)
    wb = whole.load()
    sr = native.NativeStreamReader(sam)
    assert sr.avg_read_length == wb.avg_read_length
    db = build_toy_db(toy_dir)
    st_w = profile_file(ProfileOptions(), copy.deepcopy(db), sam,
                        engine=EngineOptions(phase_log=False))
    st_s = profile_file_streaming(
        ProfileOptions(), copy.deepcopy(db), sam,
        engine=EngineOptions(phase_log=False), chunk_targets=128)
    assert st_w.options.bin_width == st_s.options.bin_width
    assert_states_equal(st_w, st_s)


@pytest.mark.parametrize("chunk", [512, 4096])
def test_streaming_profile_matches_oracle(toy_dir, chunk):
    st_o, _ = run_both(toy_dir)
    db = copy.deepcopy(build_toy_db(toy_dir))
    st_s = profile_file_streaming(
        ProfileOptions(), db, toy_dir.sam_path,
        engine=EngineOptions(phase_log=False), chunk_targets=chunk)
    assert_states_equal(st_o, st_s)


def test_streaming_plan_before_eof(tmp_path, monkeypatch):
    # the stream decoder knows the file's longest read only at EOF; until
    # then max_targets reads 0.  Each chunk's segment plan must come from
    # the chunk itself, or reads with more targets than the plan's window
    # are reduced wrongly.  Simulate a decoder that is never at EOF when a
    # chunk is taken, on reads of up to 3 targets.
    import bench

    w = bench.make_workload(20_000, 30, seed=3)
    sam = str(tmp_path / "runs3.sam")
    bench.write_bench_sam(sam, w, 30)
    db = bench.make_bench_db(w, 30)
    st_w = profile_file(ProfileOptions(), copy.deepcopy(db), sam,
                        engine=EngineOptions(phase_log=False))
    monkeypatch.setattr(native.NativeStreamReader, "max_targets",
                        property(lambda self: 0))
    st_s = profile_file_streaming(
        ProfileOptions(), copy.deepcopy(db), sam,
        engine=EngineOptions(phase_log=False), chunk_targets=4096)
    assert_states_equal(st_w, st_s)


def test_streaming_profile_no_coverage(toy_dir):
    st_o, _ = run_both(toy_dir)
    db = copy.deepcopy(build_toy_db(toy_dir))
    st_s = profile_file_streaming(
        ProfileOptions(), db, toy_dir.sam_path,
        engine=EngineOptions(phase_log=False, fetch_coverage=False),
        chunk_targets=700)
    assert st_o.abundance_rows() == st_s.abundance_rows()
    assert st_o.taxon_id__read_count == st_s.taxon_id__read_count
    np.testing.assert_array_equal(st_o.uniq_reads_count2,
                                  st_s.uniq_reads_count2)


def test_streaming_bam_matches_whole(toy_dir, tmp_path):
    ds = build_toy_dataset(str(tmp_path), n_extra=2500, seed=9)
    bam = write_bam(str(tmp_path), ds.records)
    db = build_toy_db(ds)
    st_w = profile_file(ProfileOptions(), copy.deepcopy(db), bam,
                        engine=EngineOptions(phase_log=False))
    st_s = profile_file_streaming(
        ProfileOptions(), copy.deepcopy(db), bam,
        engine=EngineOptions(phase_log=False), chunk_targets=600)
    assert_states_equal(st_w, st_s)


def test_bam_prefetch_backpressure(tmp_path):
    # A BAM whose decompressed stream exceeds the PrefetchSource byte
    # budget (48 MB): the producer must block, resume, and keep chunks in
    # order; decode must equal the SAM twin record-for-record.  Uses the
    # bench workload writers (vectorized), ~350k records ~= 97 MB raw.
    import bench
    from slimm_jax.io import native

    if not native.available():
        import pytest
        pytest.skip("native library not built")
    w = bench.make_workload(350_000, 20, seed=11)
    sam = str(tmp_path / "bp.sam")
    bam = str(tmp_path / "bp.bam")
    bench.write_bench_sam(sam, w, 20)
    bench.write_bench_bam(bam, w, 20)
    a = native.NativeAlignmentFile(sam).load()
    b = native.NativeAlignmentFile(bam).load()
    assert a.hits_count == b.hits_count == len(w["read_id"])
    assert a.n_reads == b.n_reads
    np.testing.assert_array_equal(a.rid, b.rid)
    np.testing.assert_array_equal(a.pos, b.pos)
    np.testing.assert_array_equal(a.read_id, b.read_id)
    # streamed pieces over the same prefetch pipeline
    sr = native.NativeStreamReader(bam)
    n_pad = 1 << 17
    total = 0
    while True:
        p = sr.next_piece_v2(n_pad, n_pad, w["lengths"], 74, 148, np.uint8)
        if p is None:
            break
        total += int(p[3])
    assert total == len(a.rid)


@pytest.mark.parametrize("data,model", [(8, 1), (4, 2), (2, 4)])
def test_streaming_sharded_matches_whole(toy_dir, data, model):
    # streaming x sharding composition: chunked
    # dispatch over a (data x model) mesh is bit-equal to the
    # single-device whole-file dispatch — partial per-data-shard
    # histograms merge with ONE integer psum at the cutoffs/finalize
    from slimm_jax.parallel import ShardedRunner

    db = build_toy_db(toy_dir)
    st_w = profile_file(ProfileOptions(), copy.deepcopy(db),
                        toy_dir.sam_path,
                        engine=EngineOptions(phase_log=False))
    runner = ShardedRunner(num_shards=data, model_shards=model)
    st_s = profile_file_streaming(
        ProfileOptions(), copy.deepcopy(db), toy_dir.sam_path,
        engine=EngineOptions(phase_log=False), chunk_targets=512,
        sharded_runner=runner)
    assert_states_equal(st_w, st_s)


def test_streaming_sharded_large_no_coverage(tmp_path):
    # abundance-only mode (no -ro/-co): per-contig u2 counts ride the
    # small fused histogram; larger random input forces several chunks
    from slimm_jax.parallel import ShardedRunner

    ds = build_toy_dataset(str(tmp_path), n_extra=3000, seed=31)
    db = build_toy_db(ds)
    st_w = profile_file(ProfileOptions(), copy.deepcopy(db), ds.sam_path,
                        engine=EngineOptions(phase_log=False))
    st_s = profile_file_streaming(
        ProfileOptions(), copy.deepcopy(db), ds.sam_path,
        engine=EngineOptions(phase_log=False, fetch_coverage=False),
        chunk_targets=700, sharded_runner=ShardedRunner(num_shards=4,
                                                        model_shards=2))
    assert st_w.abundance_rows() == st_s.abundance_rows()
    assert st_w.taxon_id__read_count == st_s.taxon_id__read_count
    np.testing.assert_array_equal(st_w.uniq_reads_count2,
                                  st_s.uniq_reads_count2)


def test_streaming_sharded_host_cache(toy_dir):
    # force the host-copy chunk cache (zero device budget → pass B
    # re-uploads every chunk)
    from slimm_jax.parallel import ShardedRunner

    db = build_toy_db(toy_dir)
    st_w = profile_file(ProfileOptions(), copy.deepcopy(db),
                        toy_dir.sam_path,
                        engine=EngineOptions(phase_log=False))
    st_s = profile_file_streaming(
        ProfileOptions(), copy.deepcopy(db), toy_dir.sam_path,
        engine=EngineOptions(phase_log=False, stream_device_cache_bytes=0),
        chunk_targets=512, sharded_runner=ShardedRunner(num_shards=8))
    assert_states_equal(st_w, st_s)


def test_streaming_multihost_runner_single_process(toy_dir):
    # MultiHostRunner degenerates to the 1-D sharded runner in one process
    from slimm_jax.parallel.multihost import MultiHostRunner

    db = build_toy_db(toy_dir)
    st_w = profile_file(ProfileOptions(), copy.deepcopy(db),
                        toy_dir.sam_path,
                        engine=EngineOptions(phase_log=False))
    st_s = profile_file_streaming(
        ProfileOptions(), copy.deepcopy(db), toy_dir.sam_path,
        engine=EngineOptions(phase_log=False), chunk_targets=512,
        sharded_runner=MultiHostRunner())
    assert_states_equal(st_w, st_s)


def _non_grouped_records(n=200, stride=3):
    # coordinate-sorted-style input: reads reappear non-consecutively
    records = []
    for k in range(n):
        records.append((f"r{k}", 0, k % 5, 10 * k % 2500, 100))
    for k in range(0, n, stride):  # reappearances far from the first hit
        records.append((f"r{k}", 0, (k + 1) % 5, 7 * k % 2500, 100))
    return records


def test_stream_reader_regroups_non_grouped(tmp_path):
    # the C++ stream decoder regroups coordinate-sorted input at EOF
    # (counting sort) instead of forcing a second whole-file decode:
    # chunks come out read-grouped and identical to the whole-file arrays
    records = _non_grouped_records()
    sam = write_sam(str(tmp_path), records, name="nongrouped.sam")
    bam = write_bam(str(tmp_path), records, name="nongrouped.bam")
    for path in (sam, bam):
        whole = native.NativeAlignmentFile(path).load()
        sr = native.NativeStreamReader(path)
        parts = []
        while True:
            c = sr.next_chunk(64)
            if c is None:
                break
            parts.append(c)
        assert sr.grouped  # output contract: arrays are read-grouped
        read_id = np.concatenate([c[0] for c in parts])
        rid = np.concatenate([c[1] for c in parts])
        assert np.all(read_id[:-1] <= read_id[1:])
        np.testing.assert_array_equal(read_id,
                                      whole.read_id.astype(np.int32))
        np.testing.assert_array_equal(rid, whole.rid)
        assert sr.totals()[:2] == (whole.n_reads, whole.hits_count)
        # the regroup re-measures the longest run (whole-file decode
        # reports 0 for non-grouped input and lets the host re-measure)
        bnd = np.flatnonzero(np.r_[True, read_id[1:] != read_id[:-1], True])
        assert sr.max_targets == int(np.diff(bnd).max()) > 1


def test_streaming_non_grouped(toy_dir, tmp_path):
    # chunk streaming on coordinate-sorted-style input rides the EOF
    # regroup — bit-identical to the whole-file path, no Python fallback
    sam = write_sam(str(tmp_path), _non_grouped_records(),
                    name="nongrouped.sam")
    db = build_toy_db(toy_dir)
    st_w = profile_file(ProfileOptions(), copy.deepcopy(db), sam,
                        engine=EngineOptions(phase_log=False))
    st_s = profile_file_streaming(
        ProfileOptions(), copy.deepcopy(db), sam,
        engine=EngineOptions(phase_log=False), chunk_targets=64)
    assert_states_equal(st_w, st_s)


def test_overlap_non_grouped(toy_dir, tmp_path):
    # the whole-file overlap path accepts coordinate-sorted input (the
    # pieces upload after the EOF regroup, still one fused dispatch) —
    # _profile_file_overlap must NOT bail to the standard path
    from slimm_jax.engine.pipeline import _profile_file_overlap

    sam = write_sam(str(tmp_path), _non_grouped_records(400, 2),
                    name="nongrouped2.sam")
    db = build_toy_db(toy_dir)
    st_w = profile_file(ProfileOptions(), copy.deepcopy(db), sam,
                        engine=EngineOptions(phase_log=False,
                                             overlap_min_bytes=0))
    st_o = _profile_file_overlap(
        ProfileOptions(), copy.deepcopy(db), sam,
        EngineOptions(phase_log=False, overlap_piece_targets=2048))
    assert st_o is not None, "overlap path fell back on non-grouped input"
    assert_states_equal(st_w, st_o)


def test_streaming_sharded_non_grouped(toy_dir, tmp_path):
    # (data x model) sharded streaming over coordinate-sorted input
    from slimm_jax.parallel import ShardedRunner

    sam = write_sam(str(tmp_path), _non_grouped_records(),
                    name="nongrouped.sam")
    db = build_toy_db(toy_dir)
    st_w = profile_file(ProfileOptions(), copy.deepcopy(db), sam,
                        engine=EngineOptions(phase_log=False))
    st_s = profile_file_streaming(
        ProfileOptions(), copy.deepcopy(db), sam,
        engine=EngineOptions(phase_log=False), chunk_targets=64,
        sharded_runner=ShardedRunner(num_shards=2, model_shards=2))
    assert_states_equal(st_w, st_s)


def _force_parallel(monkeypatch, threads=3):
    # the parallel sharded decode normally needs a >=32MB mmap and >=3
    # cores; force it for small test files
    monkeypatch.setenv("SLIMM_PARALLEL_MIN_BYTES", "65536")
    monkeypatch.setenv("SLIMM_DECODE_THREADS", str(threads))


def test_parallel_decode_matches_whole_file(tmp_path, monkeypatch):
    # parallel sharded decode (N workers over byte ranges, order-preserving
    # merge) must produce the exact whole-file arrays, counters, sample
    _force_parallel(monkeypatch)
    ds = build_toy_dataset(str(tmp_path), n_extra=30000, seed=3)
    whole = native.NativeAlignmentFile(ds.sam_path).load()
    sr = native.NativeStreamReader(ds.sam_path)
    parts = []
    while True:
        c = sr.next_chunk(512)
        if c is None:
            break
        parts.append(c)
    assert len(parts) > 1
    read_id = np.concatenate([c[0] for c in parts])
    np.testing.assert_array_equal(read_id, whole.read_id.astype(np.int32))
    np.testing.assert_array_equal(np.concatenate([c[1] for c in parts]),
                                  whole.rid)
    np.testing.assert_array_equal(np.concatenate([c[2] for c in parts]),
                                  whole.pos)
    assert sr.totals()[:2] == (whole.n_reads, whole.hits_count)
    assert sr.avg_read_length == whole.avg_read_length
    assert sr.max_targets == whole.max_targets


def test_parallel_decode_seam_dedup(tmp_path, monkeypatch):
    # every read repeats its targets ([0,1,2,0,1,2]) so wherever the shard
    # cuts land, the seam read's continuation must dedup first-hit-wins
    # across the cut; many small shards maximize seam coverage
    _force_parallel(monkeypatch, threads=4)
    records = []
    for k in range(20000):
        for rep in range(2):
            for c in range(3):
                records.append((f"s{k:06d}", 0, c, (11 * k + c) % 2500, 24))
    sam = write_sam(str(tmp_path), records, name="seam.sam")
    sr = native.NativeStreamReader(sam)
    parts = []
    while True:
        c = sr.next_chunk(4096)
        if c is None:
            break
        parts.append(c)
    read_id = np.concatenate([c[0] for c in parts])
    rid = np.concatenate([c[1] for c in parts])
    pos = np.concatenate([c[2] for c in parts])
    # exactly 3 dedup'd targets per read, with the FIRST occurrence's pos
    assert sr.totals()[0] == 20000
    assert len(read_id) == 60000
    assert sr.max_targets == 3
    np.testing.assert_array_equal(np.bincount(read_id),
                                  np.full(20000, 3))
    np.testing.assert_array_equal(rid.reshape(20000, 3),
                                  np.tile([0, 1, 2], (20000, 1)))
    ks = np.arange(20000)[:, None]
    np.testing.assert_array_equal(
        pos.reshape(20000, 3), (11 * ks + np.arange(3)[None, :]) % 2500)
    # and the whole-file decoder agrees bit-for-bit
    whole = native.NativeAlignmentFile(sam).load()
    np.testing.assert_array_equal(read_id, whole.read_id.astype(np.int32))
    np.testing.assert_array_equal(rid, whole.rid)
    np.testing.assert_array_equal(pos, whole.pos)


def test_parallel_decode_cross_shard_duplicate_fails_over(tmp_path,
                                                          monkeypatch):
    # a read reappearing BEYOND the probe coverage (probe stops after the
    # 4MB window holding the 100k-th sample) defeats the groupedness
    # probe; the bloom-backed cross-shard check must catch it and the
    # profile path must fall back to the (order-insensitive) whole-file
    # decode with identical results
    _force_parallel(monkeypatch)
    records = [(f"a{k:06d}", 0, k % 5, (13 * k) % 2500, 8)
               for k in range(300000)]
    records.append(("a000050", 0, 2, 99, 8))   # far-away reappearance
    sam = write_sam(str(tmp_path), records, name="lateshuffle.sam")
    sr = native.NativeStreamReader(sam)
    with pytest.raises(ValueError, match="not qname-grouped"):
        while sr.next_chunk(4096) is not None:
            pass
    db = build_toy_db(build_toy_dataset(str(tmp_path)))
    st_w = profile_file(ProfileOptions(), copy.deepcopy(db), sam,
                        engine=EngineOptions(phase_log=False))
    st_s = profile_file_streaming(
        ProfileOptions(), copy.deepcopy(db), sam,
        engine=EngineOptions(phase_log=False), chunk_targets=8192)
    assert_states_equal(st_w, st_s)


def test_parallel_decode_full_profile(tmp_path, monkeypatch):
    # end-to-end: overlap path + chunk streaming over the parallel decoder
    _force_parallel(monkeypatch)
    ds = build_toy_dataset(str(tmp_path), n_extra=12000, seed=21)
    db = build_toy_db(ds)
    monkeypatch.setenv("SLIMM_PARALLEL_MIN_BYTES", "1000000000")
    st_serial = profile_file(ProfileOptions(), copy.deepcopy(db),
                             ds.sam_path,
                             engine=EngineOptions(phase_log=False))
    monkeypatch.setenv("SLIMM_PARALLEL_MIN_BYTES", "65536")
    st_ovl = profile_file(
        ProfileOptions(), copy.deepcopy(db), ds.sam_path,
        engine=EngineOptions(phase_log=False, overlap_min_bytes=1,
                             overlap_piece_targets=4096))
    st_str = profile_file_streaming(
        ProfileOptions(), copy.deepcopy(db), ds.sam_path,
        engine=EngineOptions(phase_log=False), chunk_targets=4096)
    assert_states_equal(st_serial, st_ovl)
    assert_states_equal(st_serial, st_str)


def test_streaming_v1_int32_positions_matches(toy_dir, monkeypatch):
    # bin tables past uint16 fall back to the v1 transfer (int32
    # positions, host pack_records_compact, decode-ahead thread) — force
    # it by shrinking the v2 gate and check bit-equality with both the
    # whole-file path and the default v2 streaming
    from slimm_jax.engine import pipeline as P

    db = build_toy_db(toy_dir)
    st_w = profile_file(ProfileOptions(), copy.deepcopy(db),
                        toy_dir.sam_path,
                        engine=EngineOptions(phase_log=False))
    st_v2 = profile_file_streaming(
        ProfileOptions(), copy.deepcopy(db), toy_dir.sam_path,
        engine=EngineOptions(phase_log=False), chunk_targets=512)
    monkeypatch.setattr(P, "V2_MAX_BIN", 0)
    st_v1 = profile_file_streaming(
        ProfileOptions(), copy.deepcopy(db), toy_dir.sam_path,
        engine=EngineOptions(phase_log=False), chunk_targets=512)
    assert_states_equal(st_w, st_v1)
    assert_states_equal(st_w, st_v2)
