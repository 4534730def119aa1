"""Native C++ decoder / baseline vs the Python reference implementations."""

import numpy as np
import pytest

from slimm_jax.io import AlignmentFile
from slimm_jax.io import native

from tests.toy import build_toy_db, make_records, write_bam, write_sam


@pytest.fixture(scope="session", autouse=True)
def ensure_native_built():
    # available() builds the library from native/ on first use
    if not native.available():
        pytest.skip("native toolchain unavailable")


def assert_batches_equal(a, b):
    assert a.hits_count == b.hits_count
    assert a.n_reads == b.n_reads
    assert a.avg_read_length == b.avg_read_length
    np.testing.assert_array_equal(np.asarray(a.read_id, np.int64),
                                  np.asarray(b.read_id, np.int64))
    np.testing.assert_array_equal(a.rid, b.rid)
    np.testing.assert_array_equal(a.pos, b.pos)


def test_native_sam_matches_python(toy_dir):
    py = AlignmentFile(toy_dir.sam_path)
    nat = native.NativeAlignmentFile(toy_dir.sam_path)
    assert nat.contig_names == py.contig_names
    np.testing.assert_array_equal(nat.contig_lengths, py.contig_lengths)
    assert_batches_equal(nat.load(), py.load())


def test_native_bam_matches_python(toy_dir):
    bam = write_bam(toy_dir.dir, toy_dir.records)
    py = AlignmentFile(bam)
    nat = native.NativeAlignmentFile(bam)
    assert nat.contig_names == py.contig_names
    np.testing.assert_array_equal(nat.contig_lengths, py.contig_lengths)
    assert_batches_equal(nat.load(), py.load())
    # BAM decode agrees with the SAM decode of the same records
    sam_batch = AlignmentFile(toy_dir.sam_path).load()
    assert_batches_equal(nat.load(), sam_batch)


def test_native_missing_file():
    with pytest.raises(FileNotFoundError):
        native.NativeAlignmentFile("/nonexistent/x.sam")


def test_native_no_seq_records(tmp_path):
    p = tmp_path / "noseq.sam"
    p.write_text("@SQ\tSN:c1\tLN:100\nq\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*\n")
    nat = native.NativeAlignmentFile(str(p))
    with pytest.raises(ZeroDivisionError):
        nat.load()


def test_baseline_counters_match_oracle(toy_dir):
    """The C++ single-core baseline reproduces the oracle's counters."""
    import copy

    from slimm_jax.config import ProfileOptions
    from slimm_jax.database import tensorize
    from slimm_jax.oracle import OracleProfiler

    db = build_toy_db(toy_dir)
    af = AlignmentFile(toy_dir.sam_path)
    batch = af.load()
    dense = tensorize(copy.deepcopy(db), af.contig_names)

    # the baseline consumes the RAW record stream (it does its own dedup);
    # rebuild it from the parsed records with the same read-key interning
    key_to_id, raw = {}, []
    for q, f, rid, pos, _ in af.raw_records():
        if (f & 0x4) or rid < 0:
            continue
        k = q + ".1" if f & 0x40 else (q + ".2" if f & 0x80 else q)
        rd = key_to_id.setdefault(k, len(key_to_id))
        raw.append((rd, rid, pos))
    raw = np.asarray(raw, np.int32)

    secs, counters = native.baseline_profile(
        raw[:, 0], raw[:, 1], raw[:, 2], len(key_to_id),
        af.contig_lengths, dense.lineage, batch.avg_read_length,
        bin_width=batch.avg_read_length)
    assert secs >= 0

    prof = OracleProfiler(ProfileOptions(), db.ac__taxid, db.taxid__name,
                          list(zip(af.contig_names,
                                   af.contig_lengths.tolist())))
    st = prof.run(af.raw_records())
    assert counters["hits"] == st.hits_count
    assert counters["matches"] == st.matches_count
    assert counters["uniq_matches"] == st.uniq_matches_count
    assert counters["uniq_matches2"] == st.uniq_matches_count2
    assert counters["n_valid_refs"] == len(st.valid_ref_ids)
    assert counters["cov_mass"] == int(st.cov.sum())
    assert counters["uniq_cov2_mass"] == int(st.uniq_cov2.sum())


def test_engine_uses_native_decoder(toy_dir):
    from slimm_jax.config import EngineOptions
    from slimm_jax.engine.pipeline import open_alignment_file

    af = open_alignment_file(toy_dir.sam_path, EngineOptions(use_native=True))
    assert isinstance(af, native.NativeAlignmentFile)
    af2 = open_alignment_file(toy_dir.sam_path, EngineOptions(use_native=False))
    assert isinstance(af2, AlignmentFile)


def test_hash_read_names_mode_matches(toy_dir):
    # 64-bit-hash read keys (billion-read scale mode): identical decode on
    # collision-free input, with no name arena kept
    py = AlignmentFile(toy_dir.sam_path)
    plain = native.NativeAlignmentFile(toy_dir.sam_path).load()
    hashed = native.NativeAlignmentFile(toy_dir.sam_path,
                                        hash_names=True).load()
    assert_batches_equal(plain, hashed)
    assert_batches_equal(py.load(), hashed)


def test_hash_read_names_engine_parity(toy_dir):
    import copy

    from slimm_jax.config import EngineOptions, ProfileOptions
    from slimm_jax.engine import profile_file
    from tests.toy import build_toy_db

    db = build_toy_db(toy_dir)
    st_a = profile_file(ProfileOptions(), copy.deepcopy(db),
                        toy_dir.sam_path,
                        engine=EngineOptions(phase_log=False))
    st_b = profile_file(ProfileOptions(), copy.deepcopy(db),
                        toy_dir.sam_path,
                        engine=EngineOptions(phase_log=False,
                                             hash_read_names=True))
    assert st_a.abundance_rows() == st_b.abundance_rows()
    assert st_a.taxon_id__read_count == st_b.taxon_id__read_count


def test_stream_take_v2_matches_host_pack(toy_dir):
    # the C++ v2 piece encoder (stpu_stream_take_v2) must produce byte-
    # identical arrays to the host reference pack (pack_records_compact2):
    # boundary bitmap, rid cast, uint32-wrap center binning, zero padding
    from slimm_jax.engine.pipeline import pack_records_compact2

    whole = native.NativeAlignmentFile(toy_dir.sam_path).load()
    af = native.NativeAlignmentFile(toy_dir.sam_path)
    n_contigs = len(af.contig_names)
    lengths = af.contig_lengths.astype(np.uint32)
    half, bw = 50, 100
    n = len(whole.read_id)
    n_pad = -(-n // 2048) * 2048

    # pack_records_compact2 picks the rid dtype from its n_contigs arg;
    # these fake contig counts force each of the three casts in turn
    for rid_dtype, fake_contigs in ((np.uint8, n_contigs),
                                    (np.int16, 1000), (np.int32, 1 << 20)):
        sr = native.NativeStreamReader(toy_dir.sam_path)
        piece = sr.next_piece_v2(n_pad, n_pad, lengths, half, bw, rid_dtype)
        bnd, rid_p, bin_p, nv = piece
        assert rid_p.dtype == rid_dtype
        ref = pack_records_compact2(
            whole.read_id.astype(np.int32), whole.rid, whole.pos, n_pad,
            fake_contigs, lengths, half, bw)
        assert nv == ref[3] == n
        np.testing.assert_array_equal(bnd, ref[0])
        np.testing.assert_array_equal(rid_p.astype(np.int32),
                                      ref[1].astype(np.int32))
        np.testing.assert_array_equal(bin_p, ref[2])
        assert sr.next_piece_v2(n_pad, n_pad, lengths, half, bw,
                                rid_dtype) is None


def test_piece_v2x_plan_matches_numpy(toy_dir):
    """stpu_stream_take_v2x's (n_reads, max_run) == the numpy recompute
    from the boundary bits it wrote (the overlap path's per-piece segment
    plan source)."""
    from slimm_jax.io import native

    if not native.available():
        import pytest
        pytest.skip("native library not built")
    whole = native.NativeAlignmentFile(toy_dir.sam_path).load()
    af = native.NativeAlignmentFile(toy_dir.sam_path)
    lengths = af.contig_lengths.astype(np.uint32)
    n = len(whole.read_id)
    n_pad = -(-n // 2048) * 2048
    sr = native.NativeStreamReader(toy_dir.sam_path)
    bnd, rid_p, bin_p, nv, n_reads, max_run = sr.next_piece_v2(
        n_pad, n_pad, lengths, 50, 100, np.uint8, with_plan=True)
    bits = np.unpackbits(bnd, bitorder="little", count=int(nv))
    starts = np.flatnonzero(bits)
    runs = np.diff(np.append(starts, int(nv)))
    assert n_reads == len(starts) == len(np.unique(whole.read_id))
    assert max_run == int(runs.max())
    # the toy file fits one piece, so the piece plan must equal the
    # whole-file max run exactly
    assert max_run == af.load().max_targets
