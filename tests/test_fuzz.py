"""Randomized fuzz harness: engine == oracle bit-for-bit on random SAMs.

Sweeps seeded random cases over the toy reference (pair flags, unmapped
records, invalid reference ids, duplicate storms forcing the log-depth
segment scans, single-contig inputs, shuffled record order, empty-seq
records, every CLI option axis) and asserts

  * full ProfileState equality between the device engine and the scalar
    oracle (assert_states_equal: counters, histograms, reports), and
  * the SURVEY §4 property invariants on the result: per-rank read-count
    sums never exceed matches, the catch-all abundance row closes the
    books (uint32 wrap), and the coverage histograms conserve the kept
    target counts.

Every case is reproducible from its printed seed.
"""

import copy
import os

import numpy as np
import pytest

from slimm_jax.config import EngineOptions, ProfileOptions
from slimm_jax.engine import profile_file
from slimm_jax.io import AlignmentFile
from slimm_jax.oracle import OracleProfiler

from tests.test_engine import assert_states_equal
from tests.toy import TOY_CONTIGS, build_toy_db, build_toy_dataset, write_sam

N_CASES = int(os.environ.get("SLIMM_FUZZ_CASES", 50))


def gen_case(rng):
    """One random (records, options) case."""
    lengths = [c[2] for c in TOY_CONTIGS]
    n_reads = int(rng.integers(5, 300))
    single_contig = rng.random() < 0.1
    pool = ([int(rng.integers(0, 6))] if single_contig else list(range(6)))
    p_unmapped = float(rng.choice([0.0, 0.05, 0.3]))
    p_invalid = float(rng.choice([0.0, 0.08]))
    p_empty_seq = float(rng.choice([0.0, 0.1]))
    dup_storm = rng.random() < 0.25
    pair_frac = float(rng.choice([0.0, 0.3, 1.0]))

    def seq_len():
        if rng.random() < p_empty_seq:
            return 0
        return int(rng.integers(10, 300))

    records = []
    for k in range(n_reads):
        qname = f"q{k}"
        flags = [0x40, 0x80] if rng.random() < pair_frac else [0]
        for fl in flags:
            n_t = int(rng.integers(1, 6))
            if dup_storm and rng.random() < 0.3:
                # long same-read runs: exceeds the shift window, forcing
                # the log-depth scan plan (and host pre-dedup)
                n_t = int(rng.integers(6, 30))
            for _ in range(n_t):
                if rng.random() < p_unmapped:
                    records.append((qname, fl | 0x4, -1, -1, seq_len()))
                    continue
                if rng.random() < p_invalid:
                    # mapped flag but no reference: decoders drop it
                    records.append((qname, fl, -1, -1, seq_len()))
                    continue
                rid = int(rng.choice(pool))
                pos = int(rng.integers(0, lengths[rid] + 50))
                records.append((qname, fl, rid, pos, seq_len()))
    if rng.random() < 0.5:
        rng.shuffle(records)   # coordinate-sorted-style order

    options = ProfileOptions(
        bin_width=int(rng.choice([0, 0, 7, 37])),
        min_reads=int(rng.choice([0, 0, 2])),
        rank=str(rng.choice(["species", "genus", "phylum",
                             "superkingdom", "all"])),
        cov_cut_off=float(rng.choice([0.95, 0.5, 1.0])),
        abundance_cut_off=float(rng.choice([0.01, 1.0])))
    return records, options


def check_invariants(st):
    # per-rank read-count sums never exceed matches (each counted read
    # contributes at most once per lineage level)
    rank_sums = {}
    for tid, count in st.taxon_id__read_count.items():
        rnk = st.taxid__name.get(tid, (0, ""))[0]
        rank_sums[rnk] = rank_sums.get(rnk, 0) + count
    for rnk in range(1, 8):
        assert rank_sums.get(rnk, 0) <= st.matches_count, (
            f"rank {rnk} count {rank_sums.get(rnk)} > matches "
            f"{st.matches_count}")
    # coverage histograms conserve the kept target counts
    assert int(st.cov.sum()) == int(st.reads_count.sum())
    assert int(st.uniq_cov.sum()) == int(st.uniq_reads_count.sum())
    assert int(st.uniq_cov2.sum()) == int(st.uniq_reads_count2.sum())
    # the catch-all abundance row closes the books (uint32 wrap)
    rows = st.abundance_rows()
    assert rows[-1][1] == "0*"
    emitted = sum(int(r[4]) for r in rows[:-1])
    assert int(rows[-1][4]) == (st.matches_count - emitted) & 0xFFFFFFFF


def check_native_baseline(db, af, options, st_o, oracle):
    """3-way cross-validation: the native single-core C++
    baseline (stpu_baseline_profile — an INDEPENDENT implementation of the
    reference's hash-map hot loops, slimm.hpp:191-303) must reproduce the
    oracle's counters on every fuzz case.  This is the strongest available
    substitute for running the unbuildable reference binary: three
    implementations (scalar oracle, dense-tensor engine, C++ hash-map
    baseline) agreeing bit-for-bit across the randomized sweep."""
    from slimm_jax.database import tensorize
    from slimm_jax.io import native

    if not native.available():
        return
    # the baseline consumes the RAW mapped-record stream with
    # first-appearance read-key interning (it does its own per-read dedup)
    key_to_id, raw = {}, []
    for q, f, rid, pos, _ in af.raw_records():
        if (f & 0x4) or rid < 0:
            continue
        k = q + ".1" if f & 0x40 else (q + ".2" if f & 0x80 else q)
        rd = key_to_id.setdefault(k, len(key_to_id))
        raw.append((rd, rid, pos))
    if not raw:
        return
    raw = np.asarray(raw, np.int32)
    dense = tensorize(copy.deepcopy(db), af.contig_names)
    bin_width = options.bin_width or st_o.avg_read_length
    _, counters = native.baseline_profile(
        raw[:, 0], raw[:, 1], raw[:, 2], len(key_to_id),
        af.contig_lengths, dense.lineage, st_o.avg_read_length,
        bin_width=bin_width, cov_cut_off=options.cov_cut_off)
    assert counters["hits"] == st_o.hits_count
    assert counters["matches"] == st_o.matches_count
    assert counters["uniq_matches"] == st_o.uniq_matches_count
    assert counters["uniq_matches2"] == st_o.uniq_matches_count2
    assert counters["n_valid_refs"] == len(st_o.valid_ref_ids)
    assert counters["cov_mass"] == int(st_o.cov.sum())
    assert counters["uniq_cov2_mass"] == int(st_o.uniq_cov2.sum())
    # LCA-assigned read total, recomputed from the oracle's post-filter
    # per-read target lists
    lca_total = sum(1 for t in oracle.reads.values() if len(t) > 1)
    assert counters["lca_total"] == lca_total


def run_case(tmp_path, db, case, records, options):
    sam = write_sam(str(tmp_path), records, name=f"fuzz_{case}.sam")
    af = AlignmentFile(sam)
    oracle = OracleProfiler(
        copy.deepcopy(options), copy.deepcopy(db).ac__taxid,
        copy.deepcopy(db).taxid__name,
        list(zip(af.contig_names, af.contig_lengths.tolist())))
    st_o = oracle.run(af.raw_records())
    st_e = profile_file(copy.deepcopy(options), copy.deepcopy(db), sam,
                        engine=EngineOptions(phase_log=False))
    if st_o.hits_count == 0:
        assert st_e.hits_count == 0
        assert st_e.matches_count == st_o.matches_count
        return
    assert_states_equal(st_o, st_e)
    check_invariants(st_o)
    check_native_baseline(db, af, options, st_o, oracle)


def test_fuzz_engine_matches_oracle(tmp_path):
    db = build_toy_db(build_toy_dataset(str(tmp_path)))
    for case in range(N_CASES):
        rng = np.random.default_rng(10_000 + case)
        records, options = gen_case(rng)
        try:
            run_case(tmp_path, db, case, records, options)
        except AssertionError as e:
            pytest.fail(f"fuzz case {case} (seed {10_000 + case}, "
                        f"{len(records)} records, {options}): {e}")


def test_fuzz_zero_mapped(tmp_path):
    # all records unmapped: both sides warn and return the early state
    db = build_toy_db(build_toy_dataset(str(tmp_path)))
    records = [(f"u{k}", 0x4, -1, -1, 80) for k in range(40)]
    run_case(tmp_path, db, "zero", records, ProfileOptions())


def test_fuzz_no_sequences(tmp_path):
    # every seq is '*': the reference divides by zero sampling the average
    # read length (misc.hpp:521) — both sides must raise
    db = build_toy_db(build_toy_dataset(str(tmp_path)))
    records = [(f"n{k}", 0, 0, 10 * k, 0) for k in range(20)]
    sam = write_sam(str(tmp_path), records, name="noseq.sam")
    af = AlignmentFile(sam)
    oracle = OracleProfiler(ProfileOptions(), copy.deepcopy(db).ac__taxid,
                            copy.deepcopy(db).taxid__name,
                            list(zip(af.contig_names,
                                     af.contig_lengths.tolist())))
    with pytest.raises(ZeroDivisionError):
        oracle.run(af.raw_records())
    with pytest.raises(ZeroDivisionError):
        profile_file(ProfileOptions(), copy.deepcopy(db), sam,
                     engine=EngineOptions(phase_log=False))
