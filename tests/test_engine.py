"""Engine ↔ oracle parity: the device pipeline must reproduce the scalar
reference semantics exactly (integer counts bit-equal; float reports
identical at 6 significant digits because they are computed by shared code
from identical integers)."""

import copy

import numpy as np
import pytest

from slimm_jax.config import EngineOptions, ProfileOptions
from slimm_jax.engine import profile_file
from slimm_jax.io import AlignmentFile
from slimm_jax.oracle import OracleProfiler

from tests.toy import build_toy_db, build_toy_dataset, make_records, write_sam


def run_both(toy_dir, records=None, options=None):
    db = build_toy_db(toy_dir)
    if records is None:
        sam_path = toy_dir.sam_path
        records = toy_dir.records
    else:
        sam_path = write_sam(toy_dir.dir, records, name="case.sam")
    opts_o = options or ProfileOptions()
    opts_e = copy.deepcopy(opts_o)
    db_o = copy.deepcopy(db)
    db_e = copy.deepcopy(db)

    af = AlignmentFile(sam_path)
    oracle = OracleProfiler(copy.deepcopy(opts_o), db_o.ac__taxid,
                            db_o.taxid__name,
                            list(zip(af.contig_names,
                                     af.contig_lengths.tolist())))
    st_o = oracle.run(af.raw_records())

    st_e = profile_file(copy.deepcopy(opts_e), db_e, sam_path,
                        engine=EngineOptions(phase_log=False))
    return st_o, st_e


def assert_states_equal(st_o, st_e):
    # scalars
    for name in ("hits_count", "matches_count", "uniq_matches_count",
                 "uniq_matches_count2", "uniq_hits_count", "reference_count",
                 "matched_ref_length", "avg_read_length"):
        assert getattr(st_o, name) == getattr(st_e, name), name
    # per-contig integer arrays
    for name in ("reads_count", "uniq_reads_count", "uniq_reads_count2",
                 "nbins", "bin_offset"):
        np.testing.assert_array_equal(getattr(st_o, name), getattr(st_e, name),
                                      err_msg=name)
    # flat coverage histograms — bit equal
    for name in ("cov", "uniq_cov", "uniq_cov2"):
        np.testing.assert_array_equal(getattr(st_o, name), getattr(st_e, name),
                                      err_msg=name)
    # float abundances identical (same shared float32 code on same ints)
    np.testing.assert_array_equal(st_o.abundance, st_e.abundance)
    np.testing.assert_array_equal(st_o.uniq_abundance, st_e.uniq_abundance)
    # filter + LCA results
    assert st_o.valid_ref_ids == st_e.valid_ref_ids
    assert st_o.taxon_id__read_count == st_e.taxon_id__read_count
    assert st_o.taxon_id__children == st_e.taxon_id__children
    # reports
    assert st_o.abundance_rows() == st_e.abundance_rows()
    assert st_o.raw_rows() == st_e.raw_rows()
    assert st_o.coverage_rows() == st_e.coverage_rows()


def test_engine_matches_oracle_toy(toy_dir):
    st_o, st_e = run_both(toy_dir)
    assert_states_equal(st_o, st_e)


def test_engine_matches_oracle_large_random(tmp_path):
    # bigger randomized dataset: 5k extra records
    ds = build_toy_dataset(str(tmp_path), n_extra=5000, seed=123)
    st_o, st_e = run_both(ds)
    assert_states_equal(st_o, st_e)


def test_engine_matches_oracle_cov_cutoff_1(toy_dir):
    # cov_cut_off == 1.0 disables the quantile cutoffs (slimm.hpp:330, 674)
    st_o, st_e = run_both(toy_dir, options=ProfileOptions(cov_cut_off=1.0))
    assert_states_equal(st_o, st_e)


def test_engine_matches_oracle_genus_rank(toy_dir):
    st_o, st_e = run_both(toy_dir, options=ProfileOptions(rank="genus"))
    assert_states_equal(st_o, st_e)


def test_engine_matches_oracle_duplicate_heavy(toy_dir):
    # adversarial: many same-read same-contig repeats in scrambled order
    rng = np.random.default_rng(5)
    records = []
    for k in range(200):
        rid = int(rng.integers(0, 5))
        for rep in range(int(rng.integers(1, 5))):
            pos = int(rng.integers(0, 3000))
            records.append((f"r{k % 37}", 0, rid, pos, 100))
    st_o, st_e = run_both(toy_dir, records=records)
    assert_states_equal(st_o, st_e)


def test_engine_matches_oracle_no_multimaps(toy_dir):
    records = [(f"r{k}", 0, k % 5, 50 * k % 3000, 100) for k in range(300)]
    st_o, st_e = run_both(toy_dir, records=records)
    assert_states_equal(st_o, st_e)


def test_engine_long_runs_doubling_scan(toy_dir):
    # reads hitting ALL 6 contigs: max_run-1 > MAX_WINDOW forces the
    # log-depth doubling-scan path for the segment reductions
    rng = np.random.default_rng(9)
    records = []
    for k in range(40):
        for rid in range(6):
            records.append((f"m{k}", 0, rid, int(rng.integers(0, 2500)), 100))
    for k in range(150):  # plus unique background so filtering keeps refs
        records.append((f"u{k}", 0, k % 5, int(rng.integers(0, 2500)), 100))
    st_o, st_e = run_both(toy_dir, records=records)
    assert_states_equal(st_o, st_e)


def _run_raw_device_dedup(toy_dir, records):
    """Engine path on RAW (non-dedup'd) records — on-device first-hit dedup."""
    from slimm_jax.engine.pipeline import profile_arrays

    db = build_toy_db(toy_dir)
    sam_path = write_sam(toy_dir.dir, records, name="raw_case.sam")

    af = AlignmentFile(sam_path)
    oracle = OracleProfiler(ProfileOptions(), copy.deepcopy(db).ac__taxid,
                            copy.deepcopy(db).taxid__name,
                            list(zip(af.contig_names,
                                     af.contig_lengths.tolist())))
    st_o = oracle.run(af.raw_records())

    batch = af.load(dedup=False)   # raw grouped records
    st_e = profile_arrays(
        ProfileOptions(), copy.deepcopy(db), af.contig_names,
        af.contig_lengths, batch.read_id.astype(np.int32), batch.rid,
        batch.pos, batch.n_reads, batch.hits_count, batch.avg_read_length,
        engine=EngineOptions(phase_log=False), deduped=False)
    return st_o, st_e


def test_engine_device_dedup_matches_oracle(toy_dir):
    # duplicates within the shift window (spans <= MAX_WINDOW)
    rng = np.random.default_rng(11)
    records = []
    for k in range(120):
        rid = int(rng.integers(0, 5))
        records.append((f"d{k}", 0, rid, int(rng.integers(0, 2500)), 100))
        if k % 3 == 0:  # a second hit on the SAME contig — must be dropped
            records.append((f"d{k}", 0, rid, int(rng.integers(0, 2500)), 100))
        if k % 4 == 0:  # and a hit on another contig
            records.append((f"d{k}", 0, (rid + 1) % 5,
                            int(rng.integers(0, 2500)), 100))
    st_o, st_e = _run_raw_device_dedup(toy_dir, records)
    assert_states_equal(st_o, st_e)


def test_engine_device_dedup_wide_span_host_fallback(toy_dir):
    # duplicate spans wider than MAX_WINDOW: r hits c0,c1,c2,c3,c4,c0 —
    # the engine must fall back to host dedup and still match
    rng = np.random.default_rng(13)
    records = []
    for k in range(60):
        for rid in [0, 1, 2, 3, 4, 0]:
            records.append((f"w{k}", 0, rid, int(rng.integers(0, 2500)), 100))
    for k in range(150):
        records.append((f"u{k}", 0, k % 5, int(rng.integers(0, 2500)), 100))
    st_o, st_e = _run_raw_device_dedup(toy_dir, records)
    assert_states_equal(st_o, st_e)


def test_batched_files_match_per_file(toy_dir, tmp_path):
    # K files with different record mixes (and thus different auto
    # bin_widths) through ONE batched dispatch == per-file dispatches
    from slimm_jax.engine.pipeline import profile_files_batched

    rng = np.random.default_rng(21)
    paths = []
    for k in range(3):
        records = []
        for i in range(150 + 40 * k):
            rid = int(rng.integers(0, 5))
            records.append((f"f{k}_r{i}", 0, rid,
                            int(rng.integers(0, 2500)), 100 + 10 * k))
            if i % 7 == 0:
                records.append((f"f{k}_r{i}", 0, (rid + 2) % 5,
                                int(rng.integers(0, 2500)), 100 + 10 * k))
        paths.append(write_sam(str(tmp_path), records, name=f"batch{k}.sam"))

    db = build_toy_db(toy_dir)
    eng = EngineOptions(phase_log=False)
    batched = profile_files_batched(ProfileOptions(), copy.deepcopy(db),
                                    paths, engine=eng)
    assert [p for p, _ in batched] == paths
    for path, st_b in batched:
        st_s = profile_file(ProfileOptions(), copy.deepcopy(db), path,
                            engine=eng)
        assert_states_equal(st_s, st_b)


def test_rank_all_pinned_output(toy_dir):
    # -r all: get_considered_ranks pushes 7..0 but write_abundance reads only
    # [0]=superkingdom (parent) and [1]=phylum (slimm.hpp:498-514, 733-843),
    # so the profile is a PHYLUM-level report
    st_o, st_e = run_both(toy_dir, options=ProfileOptions(rank="all"))
    assert_states_equal(st_o, st_e)
    rows = st_e.abundance_rows()
    main = [r for r in rows if not r[1].endswith("*")]
    assert main, "expected phylum rows"
    assert all(r[0] == "phylum" for r in rows)
    by_tid = {r[1]: r for r in main}
    assert set(by_tid) <= {"1224", "1239"}
    assert by_tid["1224"][2] == "k__Bacteria|p__Proteobacteria"
    assert by_tid["1239"][2] == "k__Bacteria|p__Firmicutes"
    # catch-all closes abundance to 100 (float32 seq-sum of emitted rows)
    from slimm_jax.state import f32
    total = f32(0.0)
    for r in rows:
        total = f32(total + f32(float(r[3])))
    assert abs(float(total) - 100.0) < 1e-3
    assert rows[-1][1] == "0*"
    assert rows[-1][2].endswith("p__unknown_phylum")


def test_rank_superkingdom_pinned_output(toy_dir):
    # -r superkingdom: the reference pushes ONE considered rank and then
    # reads considered_ranks[1] out of bounds (slimm.hpp:506-508, 739);
    # the defined divergence is parent_rank == rank == superkingdom
    # (taxonomy.considered_ranks docstring), making the unclassified
    # residual identically zero
    st_o, st_e = run_both(toy_dir,
                          options=ProfileOptions(rank="superkingdom"))
    assert_states_equal(st_o, st_e)
    rows = st_e.abundance_rows()
    assert all(r[0] == "superkingdom" for r in rows)
    main = [r for r in rows if not r[1].endswith("*")]
    assert [r[1] for r in main] == ["2"]
    assert main[0][2] == "k__Bacteria"
    # every classified read lands on Bacteria; no unclassified parent rows
    assert [r[1] for r in rows if r[1].endswith("*")] == ["0*"]
    assert rows[-1][2] == "k__unknown_superkingdom"
    assert int(main[0][4]) == st_e.taxon_id__read_count[2]


def test_verbose_rank_summary_line(toy_dir, tmp_path, capsys):
    # verbose per-rank summary (slimm.hpp:836-840): right-aligned count and
    # rank name, "bellow" typo verbatim
    from slimm_jax.engine.reports import write_abundance

    st_o, st_e = run_both(toy_dir, options=ProfileOptions(verbose=True))
    write_abundance(st_e, str(tmp_path / "out"), "toy-reads.sam")
    err = capsys.readouterr().err
    n = st_e.rank_row_count
    f = st_e.rank_failed_count
    assert f"\n{n:>4}{'species':>15} ({f} bellow cutoff i.e. 0.01)" in err


def test_nested_lca_propagation_pinned(toy_dir):
    # Nested LCAs: the toy multimaps produce LCA counts at strain 100001,
    # species 562 and family 543, where each is an ancestor of the previous.
    # The reference's propagation order is unordered_map iteration order
    # (slimm.hpp:559-586) — run-order-dependent for the children sets; the
    # repo's canonical sorted-key order (state.propagate_counts) is pinned
    # here, including the row content derived from the children sets
    st_o, st_e = run_both(toy_dir, options=ProfileOptions(rank="family"))
    assert_states_equal(st_o, st_e)
    # 543 propagated from both its own LCA reads (children {2,3}) and the
    # species/strain LCAs below it (children {0,1,2} via lineage walks)
    assert sorted(st_e.taxon_id__children[543]) == [0, 1, 2, 3]
    assert sorted(st_e.taxon_id__children[562]) == [0, 1, 2]
    assert st_e.taxon_id__read_count[543] == 444
    assert st_e.taxon_id__read_count[562] == 339
    rows = st_e.abundance_rows()
    assert rows[0] == (
        "family", "543",
        "k__Bacteria|p__Proteobacteria|c__Gammaproteobacteria|"
        "o__Enterobacterales|f__Enterobacteriaceae", "84.7328", "444")
    assert rows[1] == (
        "family", "186817",
        "k__Bacteria|p__Firmicutes|c__Bacilli|o__Bacillales|f__Bacillaceae",
        "11.4504", "60")
    assert rows[-1][1] == "0*" and rows[-1][4] == "20"


def test_engine_no_coverage_fetch_matches_oracle(toy_dir):
    # fetch_coverage=False (the default CLI profile run): the bin-domain
    # uniq_cov2 histogram is replaced by small per-contig/per-taxid
    # histograms — every integer counter and report row must be unchanged
    db = build_toy_db(toy_dir)
    af = AlignmentFile(toy_dir.sam_path)
    oracle = OracleProfiler(ProfileOptions(), copy.deepcopy(db).ac__taxid,
                            copy.deepcopy(db).taxid__name,
                            list(zip(af.contig_names,
                                     af.contig_lengths.tolist())))
    st_o = oracle.run(af.raw_records())
    st_e = profile_file(ProfileOptions(), copy.deepcopy(db),
                        toy_dir.sam_path,
                        engine=EngineOptions(phase_log=False,
                                             fetch_coverage=False))
    for name in ("hits_count", "matches_count", "uniq_matches_count",
                 "uniq_matches_count2", "reference_count"):
        assert getattr(st_o, name) == getattr(st_e, name), name
    np.testing.assert_array_equal(st_o.reads_count, st_e.reads_count)
    np.testing.assert_array_equal(st_o.uniq_reads_count2,
                                  st_e.uniq_reads_count2)
    assert st_o.valid_ref_ids == st_e.valid_ref_ids
    assert st_o.taxon_id__read_count == st_e.taxon_id__read_count
    assert st_o.taxon_id__children == st_e.taxon_id__children
    assert st_o.abundance_rows() == st_e.abundance_rows()
    assert st_e.cov is None and st_e.uniq_cov2 is None  # not fetched


def test_pair_channel_no_agreeing_level(toy_dir):
    # Reads whose targets disagree at EVERY lineage level (contig 5 has an
    # all-zero lineage; the DB contigs end in superkingdom 2): the
    # reference's get_lca falls through its loop and returns the
    # last-inserted level-7 value (slimm.hpp:516-531) — the pair channel's
    # superkingdom codes (codes >= 8, pipeline._pass_b_local) must
    # reproduce the children sets for that corner exactly.
    records = list(make_records())
    for k in range(12):   # contigs {0, 5}: no level agrees; lca = 0
        records.append((f"m_noagree_{k}", 0, 0, 100 + 50 * k, 100))
        records.append((f"m_noagree_{k}", 0, 5, 30 + 20 * k, 100))
    for k in range(8):    # contigs {4, 5}: max rid is 5 → lca = 0 again
        records.append((f"m_noagree2_{k}", 0, 4, 70 + 40 * k, 100))
        records.append((f"m_noagree2_{k}", 0, 5, 10 + 25 * k, 100))
    st_o, st_e = run_both(toy_dir, records=records)
    assert 0 in st_o.taxon_id__read_count  # the corner actually fired
    assert {0, 5} <= st_o.taxon_id__children[0]
    assert_states_equal(st_o, st_e)


def test_deep_bin_overflow_hits_packed_fallback():
    # >2^16 unique reads all centered in ONE bin: pass A's value-packed
    # uint32 scatter overflows its 16-bit cov field; the total-mass guard
    # must route the FULL fused program to the exact two-scatter fallback
    # (tests/test_ops.py covers _hist2 in isolation; this locks the
    # end-to-end counters)
    from slimm_jax.database import SlimmDatabase
    from slimm_jax.engine.pipeline import profile_arrays

    n = 70_000
    lineage = [9, 8, 7, 6, 5, 4, 3, 2]
    db = SlimmDatabase()
    db.ac__taxid["c1"] = list(lineage)
    for lvl, tid in enumerate(lineage):
        db.taxid__name.setdefault(tid, (lvl, f"t{tid}"))
    read_id = np.arange(n, dtype=np.int32)
    rid = np.zeros(n, np.int32)
    pos = np.zeros(n, np.int32)
    st = profile_arrays(ProfileOptions(), db, ["c1"],
                        np.array([500], np.int64), read_id, rid, pos,
                        n, n, 100,
                        engine=EngineOptions(phase_log=False))
    # center = min(0 + 50, 500) = 50 -> bin 0 of 6
    assert int(st.cov[0]) == n and int(st.cov.sum()) == n
    assert int(st.uniq_cov[0]) == n
    assert int(st.reads_count[0]) == n
    assert int(st.uniq_reads_count[0]) == n
    assert st.uniq_matches_count == n
