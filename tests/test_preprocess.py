"""Preprocessing tooling: genome selection priority, taxonomy reduction,
FASTA merge header convention (reference preprocessing/ scripts)."""

import gzip
import io
import os

from slimm_jax.tools.preprocess import (
    AssemblyCandidate, build_plan, load_taxonomy_dmp, merge_genome_file,
    merge_genomes, parse_assembly_summary, parse_categories, reduce_taxonomy,
    select_genome, write_reduced_dmp)


def cand(level="Contig", category="na", taxid="7", date="2020/01/01"):
    return AssemblyCandidate(level=level, date=date, url="u",
                             taxid_str=taxid, category=category)


def test_select_priority_reference_first():
    c = [cand("Contig"), cand("Complete Genome"),
         cand("Scaffold", category="representative genome"),
         cand("Chromosome", category="reference genome")]
    assert select_genome(7, c).category == "reference genome"
    c = [cand("Contig"), cand("Complete Genome"),
         cand("Scaffold", category="representative genome")]
    assert select_genome(7, c).category == "representative genome"
    c = [cand("Chromosome"), cand("Complete Genome")]
    assert select_genome(7, c).level == "Complete Genome"
    assert select_genome(7, [cand("Chromosome")]).level == "Chromosome"


def test_select_scaffold_contig_gated_on_last_candidate():
    # Scaffold/Contig only picked when the LAST candidate's taxid matches
    # (the reference's leaked loop variable, download_refs.py:176) or the
    # candidate list has a single entry
    c = [cand("Scaffold", taxid="7"), cand("Contig", taxid="8")]
    assert select_genome(7, c) is None          # last taxid 8 != 7
    c = [cand("Contig", taxid="8"), cand("Scaffold", taxid="7")]
    assert select_genome(7, c).level == "Scaffold"
    assert select_genome(9, [cand("Scaffold", taxid="8")]).level == "Scaffold"


def test_categories_and_summary_parsing():
    cats = ["B\t100\t101\n", "V\t200\t201\n", "E\t300\t301\n"]
    initial = parse_categories(cats, "AB", subset_taxids=[300])
    assert set(initial) == {100, 101, 300, 301}
    line = ("\t".join(["GCF_1", "x", "x", "x", "na", "101", "101", "x", "x",
                       "x", "latest", "Complete Genome", "x", "2020", "x",
                       "x", "x", "x", "x", "ftp://host/genomes/GCF_1"])
            + "\n")
    out = parse_assembly_summary([line], initial)
    assert 101 in out and out[101][0].url.endswith("/GCF_1_genomic.fna.gz")


def test_reduce_taxonomy_walks_to_root(tmp_path):
    nodes = ["7\t|\t6\t|\tspecies\t|\n", "6\t|\t1\t|\tgenus\t|\n",
             "9\t|\t8\t|\tspecies\t|\n"]  # 8 missing from nodes
    names = ["7\t|\tEsch coli\t|\t\t|\tscientific name\t|\n",
             "6\t|\tEscherichia\t|\t\t|\tscientific name\t|\n"]
    parent, rank, nm = load_taxonomy_dmp(nodes, names)
    keep = reduce_taxonomy({7: 1, 9: 1}, parent, rank, nm)
    assert set(keep) == {7, 6, 9}   # 9 kept, walk broken at missing 8
    nodes_out = str(tmp_path / "nodes.dmp")
    names_out = str(tmp_path / "names.dmp")
    write_reduced_dmp(keep, parent, rank, nm, nodes_out, names_out)
    p2, r2, n2 = load_taxonomy_dmp(open(nodes_out), open(names_out))
    assert p2[7] == 6 and r2[6] == "genus" and n2[7] == "Esch coli"


def test_merge_genome_file_kraken_headers(tmp_path):
    fa = tmp_path / "42.fna.gz"
    with gzip.open(fa, "wt") as f:
        f.write(">ACC1.1 first contig\nACGTACGTAC\nGGGG\n")
        f.write(">ACC2.1 plasmid pXYZ\nTTTT\n")
        f.write(">ACC3.1 second contig\nCCCC\n")
    out = io.StringIO()
    count, plasmids = merge_genome_file(str(fa), "42", out)
    text = out.getvalue().splitlines()
    assert count == 2 and plasmids == 1
    assert text[0] == ">ACC1.1|kraken:taxid|42 first contig"
    assert text[1] == "ACGTACGTAC"
    # second contig joined by an N-run of the first data line's width
    assert text[3] == "N" * 10
    assert "plasmid" not in out.getvalue()
    # and the header parses back to the accession the DB builder expects
    from slimm_jax.taxonomy import accession_id
    assert accession_id(text[0][1:]) == "ACC1"


def test_merge_genomes_directory(tmp_path):
    d = tmp_path / "genomes"
    d.mkdir()
    for taxid in (7, 8):
        with gzip.open(d / f"{taxid}.fna.gz", "wt") as f:
            f.write(f">A{taxid}.1 x\nACGT\n")
    out_path = str(tmp_path / "combined.fna")
    total = merge_genomes(str(d), out_path)
    text = open(out_path).read()
    assert total == 2
    assert ">A7.1|kraken:taxid|7 x" in text
    assert ">A8.1|kraken:taxid|8 x" in text


def test_build_plan_end_to_end():
    cats = ["B\t100\t101\n"]
    summary = ["#header\n",
               "\t".join(["GCF_1", "x", "x", "x", "reference genome", "101",
                          "101", "x", "x", "x", "latest", "Complete Genome",
                          "x", "2020", "x", "x", "x", "x", "x",
                          "ftp://h/g/GCF_1"]) + "\n"]
    nodes = ["101\t|\t100\t|\tspecies\t|\n", "100\t|\t1\t|\tgenus\t|\n"]
    names = ["101\t|\tSp one\t|\t\t|\tscientific name\t|\n",
             "100\t|\tGen one\t|\t\t|\tscientific name\t|\n"]
    plan = build_plan(cats, summary, nodes, names, groups="B")
    assert 101 in plan.selections
    assert set(plan.keep_taxids) == {100, 101}
