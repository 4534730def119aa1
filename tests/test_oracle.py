import numpy as np
import pytest

from slimm_jax.config import ProfileOptions
from slimm_jax.oracle import OracleProfiler, average_read_length
from slimm_jax.taxonomy import Rank

from tests.toy import READ_LEN, build_toy_db, make_records


@pytest.fixture(scope="module")
def toy_state(toy_dir):
    db = build_toy_db(toy_dir)
    opts = ProfileOptions(cov_cut_off=0.95, abundance_cut_off=0.01)
    prof = OracleProfiler(opts, db.ac__taxid, db.taxid__name, toy_dir.contigs)
    state = prof.run(toy_dir.records)
    return prof, state


def test_avg_read_length():
    recs = [("a", 0, 0, 0, 100), ("b", 0, 0, 0, 0), ("c", 0, 0, 0, 101)]
    assert average_read_length(recs) == 100  # integer division, 0-len skipped


def test_counters(toy_state, toy_dir):
    _, st = toy_state
    mapped = [r for r in toy_dir.records if not (r[1] & 0x4) and r[2] >= 0]
    assert st.hits_count == len(mapped)
    assert st.avg_read_length == READ_LEN
    # distinct read keys (pairs split into .1/.2)
    keys = set()
    for q, f, _, _, _ in mapped:
        keys.add(q + ".1" if f & 0x40 else (q + ".2" if f & 0x80 else q))
    assert st.matches_count == len(keys)


def test_first_hit_wins(toy_dir):
    # dup_k reads hit contig 3 twice; only the first bin may count
    db = build_toy_db(toy_dir)
    opts = ProfileOptions()
    recs = [("dup", 0, 3, 100, READ_LEN), ("dup", 0, 3, 5000, READ_LEN)]
    prof = OracleProfiler(opts, db.ac__taxid, db.taxid__name, toy_dir.contigs)
    st = prof.run(recs)
    assert st.hits_count == 2            # both records counted as hits
    assert st.matches_count == 1
    assert st.reads_count[3] == 1        # but only one target position
    assert st.cov.sum() == 1
    first_bin = (100 + READ_LEN // 2) // st.options.bin_width
    assert st.bins("cov", 3)[first_bin] == 1


def test_pair_suffix_keys(toy_dir):
    db = build_toy_db(toy_dir)
    recs = [("p", 0x40, 0, 100, READ_LEN), ("p", 0x80, 0, 4000, READ_LEN)]
    prof = OracleProfiler(ProfileOptions(), db.ac__taxid, db.taxid__name,
                          toy_dir.contigs)
    st = prof.run(recs)
    assert st.matches_count == 2         # p.1 and p.2 are distinct reads
    assert st.uniq_matches_count == 2


def test_lca_levels(toy_dir):
    db = build_toy_db(toy_dir)
    opts = ProfileOptions(cov_cut_off=1.0)  # disable coverage filtering
    prof = OracleProfiler(opts, db.ac__taxid, db.taxid__name, toy_dir.contigs)
    recs = (
        # both K-12 contigs → agree at strain level 0 → LCA 100001
        [("a", 0, 0, 100, READ_LEN), ("a", 0, 1, 100, READ_LEN)]
        # E. coli strains → LCA species 562
        + [("b", 0, 0, 100, READ_LEN), ("b", 0, 2, 100, READ_LEN)]
        # E. coli + Shigella → LCA family 543
        + [("c", 0, 2, 100, READ_LEN), ("c", 0, 3, 100, READ_LEN)]
        # cross-phylum → LCA superkingdom 2
        + [("d", 0, 0, 100, READ_LEN), ("d", 0, 4, 100, READ_LEN)]
        # anchor uniq reads so contigs stay matched
        + [(f"u{i}", 0, i, 200, READ_LEN) for i in range(5)]
    )
    st = prof.run(recs)
    rc = st.taxon_id__read_count
    # direct LCA counts + propagation
    assert rc[100001] >= 1   # strain-level LCA happened
    assert rc[562] >= 2      # species gets strain's propagation + direct
    assert rc[543] >= 3
    assert rc[2] >= 4


def test_lca_last_inserted_wins(toy_dir):
    # contigs 0 (K-12) and 2 (O157) agree at species; the returned taxid is
    # lineage[max rid][level] — same value here, but for an all-zero level the
    # value 0 wins: contig 5 has an all-zero lineage, so any read pairing
    # contig 5 with itself only can't happen; pair 3 and 5 → first agreeing
    # level is level 0? no — lineages differ at all levels until... they never
    # agree except where both are 0.
    db = build_toy_db(toy_dir)
    opts = ProfileOptions(cov_cut_off=1.0)
    prof = OracleProfiler(opts, db.ac__taxid, db.taxid__name, toy_dir.contigs)
    lca = None
    st = prof.state
    st.avg_read_length = READ_LEN
    prof.options.bin_width = READ_LEN
    st.init_contigs([c[0] for c in toy_dir.contigs],
                    [c[1] for c in toy_dir.contigs], READ_LEN)
    # contig 3 (Shigella) vs contig 5 (all-zero lineage): no level agrees
    # (543 vs 0 etc.) → value after the loop = lineage[5][7] = 0
    lca = prof.get_lca({3, 5})
    assert lca == 0
    # contigs 0,1 agree at level 0 → 100001
    assert prof.get_lca({0, 1}) == 100001
    # contigs 0,2 agree first at level 1 → 562
    assert prof.get_lca({0, 2}) == 562


def test_abundance_rows_structure(toy_state):
    _, st = toy_state
    rows = st.abundance_rows()
    assert rows[-1][1] == "0*"                      # catch-all row last
    levels = {r[0] for r in rows}
    assert levels == {"species"}
    taxids = [r[1] for r in rows]
    # expected species present (562 E. coli, 622 Shigella, 1396 B. cereus)
    for tid in ("562", "622", "1396"):
        assert tid in taxids, f"species {tid} missing: {taxids}"
    # abundances + catch-all close to 100 (float32, 6 sig digits)
    total = sum(float(r[3]) for r in rows)
    assert abs(total - 100.0) < 1e-3


def test_read_count_conservation(toy_state):
    _, st = toy_state
    rows = st.abundance_rows()
    # sum of species-level read counts (incl. unclassified + catch-all)
    # equals matches_count exactly (integer conservation)
    total_reads = sum(int(r[4]) for r in rows)
    assert total_reads == st.matches_count


def test_raw_rows(toy_state, toy_dir):
    _, st = toy_state
    rows = st.raw_rows()
    assert len(rows) == len(toy_dir.contigs)
    header_width = 20
    for r in rows:
        assert len(r) == header_width
    # contig 5 has no DB entry → taxid 0, no_name_found
    assert rows[5][1] == "0"
    assert rows[5][2] == "no_name_found"


def test_coverage_rows(toy_state):
    _, st = toy_state
    cov, ucov, ucov2 = st.coverage_rows()
    assert len(cov) == len(st.valid_ref_ids)
    for row in cov:
        cells = row.split(",")
        rid = sorted(st.valid_ref_ids)[cov.index(row)]
        assert cells[0] == st.accessions[rid]
        assert len(cells) == 1 + 8 + int(st.nbins[rid])


def test_lineage_string(toy_state):
    prof, st = toy_state
    s = st.lineage_string_of_taxid(int(Rank.SPECIES), 562)
    assert s == ("k__Bacteria|p__Proteobacteria|c__Gammaproteobacteria|"
                 "o__Enterobacterales|f__Enterobacteriaceae|g__Escherichia|"
                 "s__Escherichia coli")
    z = st.lineage_string_of_taxid(int(Rank.SPECIES), 0)
    assert z.endswith("s__unknown_species")
    assert z.startswith("k__unknown_superkingdom")
