import numpy as np

from slimm_jax.io import AlignmentFile, collect_bam_files, tsv_file_name
from slimm_jax.io.files import get_bam_files_in_directory


def test_sam_header(toy_dir):
    af = AlignmentFile(toy_dir.sam_path)
    assert af.contig_names == [c[0] for c in toy_dir.contigs]
    assert af.contig_lengths.tolist() == [c[1] for c in toy_dir.contigs]


def test_sam_records_match(toy_dir):
    af = AlignmentFile(toy_dir.sam_path)
    parsed = af.raw_records()
    assert len(parsed) == len(toy_dir.records)
    for got, want in zip(parsed, toy_dir.records):
        assert got[0] == want[0]          # qname
        assert got[1] == want[1]          # flag
        assert got[2] == want[2]          # rid
        if want[2] >= 0:
            assert got[3] == want[3]      # pos (0-based)
        assert got[4] == want[4]          # seq_len


def test_load_arrays(toy_dir):
    af = AlignmentFile(toy_dir.sam_path)
    batch = af.load()
    mapped = [r for r in toy_dir.records if not (r[1] & 0x4) and r[2] >= 0]
    assert batch.hits_count == len(mapped)
    # targets are dedup'd per (read-key, contig) — first hit wins
    keys = set()
    for q, f, rid, _, _ in mapped:
        k = q + ".1" if f & 0x40 else (q + ".2" if f & 0x80 else q)
        keys.add((k, rid))
    assert len(batch.rid) == len(keys)
    assert batch.avg_read_length == 100
    # read ids are dense, first-appearance ordered
    assert batch.read_id.max() == batch.n_reads - 1
    first_seen = {}
    for i, ridx in enumerate(batch.read_id.tolist()):
        first_seen.setdefault(ridx, i)
    assert sorted(first_seen.values()) == list(first_seen.values())


def test_file_discovery(tmp_path):
    (tmp_path / "a.sam").write_text("")
    (tmp_path / "b.bam").write_text("")
    (tmp_path / "c.txt").write_text("")
    (tmp_path / ".hidden.sam").write_text("")
    (tmp_path / "d.sam.bak").write_text("")
    found = sorted(get_bam_files_in_directory(str(tmp_path)))
    assert [f.split("/")[-1] for f in found] == ["a.sam", "b.bam"]


def test_tsv_file_name():
    # prefix with filename component: used as-is (file_helper.hpp:100-123)
    assert tsv_file_name("/out/pfx", "/in/x.bam", "_profile") == \
        "/out/pfx_profile.tsv"
    # directory-only prefix: input stem, .sam/.bam stripped
    assert tsv_file_name("/out/", "/in/x.bam", "_profile") == \
        "/out/x_profile.tsv"
    assert tsv_file_name("/out/", "/in/x.sam", "_raw") == "/out/x_raw.tsv"
    # no-extension input keeps its name
    assert tsv_file_name("/out/", "/in/reads", "_profile") == \
        "/out/reads_profile.tsv"
