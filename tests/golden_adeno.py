"""Golden fixture derived from the reference's own example data.

The reference repo ships no golden outputs (SURVEY.md §4) — only the
adeno-associated-virus genomes at /root/reference/tests/example/
(adeno-genome.fa: NC_002077.1 "AAV-1" 4718 bp, NC_002077.2 "AAV-2"
980 bp, NC_002077.3 "AAV-1" 2110 bp).  This module derives a complete,
deterministic profiling fixture from those REAL sequences:

  * contigs: the three adeno contigs verbatim (sequence + length), each
    given a distinct accession (the reference's get_accession_id rule —
    first token split on whitespace/'.'/'|', misc.hpp:415-422 — collapses
    the original "gi|...|ref|NC_002077.x|" headers to the single
    accession "gi", so distinct accessions require renaming);
  * a mini NCBI taxonomy (names/nodes dmp) for the AAV clade: Viruses →
    Parvoviridae → Dependoparvovirus → {AAV-1, AAV-2} with one strain
    node per contig (the two "AAV-1" contigs are two strains of one
    species, mirroring the FASTA's own descriptions);
  * a deterministic synthetic SAM whose SEQ fields are true substrings
    of the adeno genomes: unique tilings per contig, species-level and
    genus-level multimappers, read pairs, same-contig duplicate hits
    (first-hit-wins), and unmapped records.

The golden `_profile/_raw/_coverage` TSV bytes under tests/golden/ are
produced by the scalar oracle (the faithful reimplementation of the
reference semantics, slimm_jax/oracle.py) and locked byte-for-byte;
regenerate with `python tests/golden_adeno.py` after an INTENDED
behavior change.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

REFERENCE_FASTA = "/root/reference/tests/example/adeno-genome.fa"
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")
READ_LEN = 32   # like the reference's adeno-reads.fa

# taxid: (parent, rank, name) — AAV clade, NCBI-style ids
ADENO_TAXONOMY = {
    1: (1, "no rank", "root"),
    10239: (1, "superkingdom", "Viruses"),
    10780: (10239, "family", "Parvoviridae"),
    10803: (10780, "genus", "Dependoparvovirus"),
    10804: (10803, "species", "Adeno-associated virus - 1"),
    10805: (10803, "species", "Adeno-associated virus - 2"),
    100804: (10804, "no rank", "Adeno-associated virus - 1 isolate A"),
    100805: (10804, "no rank", "Adeno-associated virus - 1 isolate B"),
    100806: (10805, "no rank", "Adeno-associated virus - 2 isolate A"),
}

# (accession, contig name, source header index in adeno-genome.fa, taxid)
ADENO_CONTIGS = [
    ("NC_AAV1a", "NC_AAV1a.1", 0, 100804),   # AAV-1, 4718 bp
    ("NC_AAV2", "NC_AAV2.1", 1, 100806),     # AAV-2, 980 bp
    ("NC_AAV1b", "NC_AAV1b.1", 2, 100805),   # AAV-1 (2nd genome), 2110 bp
]


def read_reference_fasta(path: str = REFERENCE_FASTA) -> list[str]:
    """The adeno contig sequences, in file order."""
    seqs, cur = [], []
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                if cur:
                    seqs.append("".join(cur))
                cur = []
            else:
                cur.append(line.strip())
    if cur:
        seqs.append("".join(cur))
    return seqs


def make_records(seqs: list[str]):
    """Deterministic alignment records (qname, flag, rid, pos0, seq).

    SEQ fields are real substrings of the adeno genomes at the aligned
    position (multimappers carry their FIRST target's substring, like a
    mapper reporting secondary alignments)."""
    lens = [len(s) for s in seqs]

    def sub(rid, pos):
        return seqs[rid][pos:pos + READ_LEN]

    records = []
    # unique tilings: dense on the AAV-1 genomes, sparse on AAV-2 so the
    # coverage-quantile filter sees a spread of cov percentages
    for k, pos in enumerate(range(0, lens[0] - READ_LEN, 40)):
        records.append((f"u1_{k}", 0, 0, pos, sub(0, pos)))
    for k, pos in enumerate(range(0, lens[2] - READ_LEN, 50)):
        records.append((f"u3_{k}", 0, 2, pos, sub(2, pos)))
    for k, pos in enumerate(range(0, lens[1] - READ_LEN, 90)):
        records.append((f"u2_{k}", 0, 1, pos, sub(1, pos)))
    # species-level multimappers: AAV-1 isolate A + isolate B → LCA 10804
    for k in range(15):
        p0 = (137 * k) % (lens[0] - READ_LEN)
        p2 = (211 * k) % (lens[2] - READ_LEN)
        records.append((f"ms_{k}", 0, 0, p0, sub(0, p0)))
        records.append((f"ms_{k}", 0, 2, p2, sub(0, p0)))
    # genus-level multimappers: AAV-1 + AAV-2 → LCA 10803
    for k in range(10):
        p0 = (173 * k) % (lens[0] - READ_LEN)
        p1 = (89 * k) % (lens[1] - READ_LEN)
        records.append((f"mg_{k}", 0, 0, p0, sub(0, p0)))
        records.append((f"mg_{k}", 0, 1, p1, sub(0, p0)))
    # read pairs: .1/.2 keys (slimm.hpp:204-209)
    for k in range(6):
        p = (97 * k) % (lens[0] - READ_LEN)
        records.append((f"pr_{k}", 0x40, 0, p, sub(0, p)))
        records.append((f"pr_{k}", 0x80, 0, (p + 200) % (lens[0] - READ_LEN),
                        sub(0, (p + 200) % (lens[0] - READ_LEN))))
    # same-contig duplicates: first hit's bin wins (read_stat.hpp:116-135)
    for k in range(5):
        records.append((f"dp_{k}", 0, 2, 30 * k, sub(2, 30 * k)))
        records.append((f"dp_{k}", 0, 2, 1000 + 30 * k, sub(2, 1000 + 30 * k)))
    # unmapped records: counted in avg read length only (misc.hpp:509-522)
    for k in range(4):
        records.append((f"un_{k}", 0x4, -1, -1, "A" * READ_LEN))
    return records


def write_inputs(d: str):
    seqs = read_reference_fasta()
    nodes_path = os.path.join(d, "nodes.dmp")
    names_path = os.path.join(d, "names.dmp")
    with open(nodes_path, "wt") as f:
        for tid, (parent, rank, _) in sorted(ADENO_TAXONOMY.items()):
            f.write(f"{tid}\t|\t{parent}\t|\t{rank}\t|\t\t|\n")
    with open(names_path, "wt") as f:
        for tid, (_, _, name) in sorted(ADENO_TAXONOMY.items()):
            f.write(f"{tid}\t|\t{name}\t|\t\t|\tscientific name\t|\n")
    fasta_path = os.path.join(d, "adeno-genomes.fa")
    with open(fasta_path, "wt") as f:
        for acc, seq_name, src, _ in ADENO_CONTIGS:
            f.write(f">{seq_name} Adeno-associated virus\n{seqs[src]}\n")
    acc_path = os.path.join(d, "adeno.accession2taxid")
    with open(acc_path, "wt") as f:
        f.write("accession\taccession.version\ttaxid\tgi\n")
        for acc, seq_name, _, taxid in ADENO_CONTIGS:
            f.write(f"{acc}\t{seq_name}\t{taxid}\t0\n")
    sam_path = os.path.join(d, "adeno-reads.sam")
    records = make_records(seqs)
    with open(sam_path, "wt") as f:
        f.write("@HD\tVN:1.6\tSO:unsorted\n")
        for (acc, seq_name, src, _) in ADENO_CONTIGS:
            f.write(f"@SQ\tSN:{seq_name}\tLN:{len(seqs[src])}\n")
        for qname, flag, rid, pos0, seq in records:
            rname = ADENO_CONTIGS[rid][1] if rid >= 0 else "*"
            pos1 = pos0 + 1 if rid >= 0 else 0
            cigar = f"{len(seq)}M" if rid >= 0 else "*"
            f.write(f"{qname}\t{flag}\t{rname}\t{pos1}\t60\t{cigar}\t*\t0\t0"
                    f"\t{seq}\t{'I' * len(seq)}\n")
    return AdenoDataset(dir=d, nodes_path=nodes_path, names_path=names_path,
                        fasta_path=fasta_path, acc2taxid_path=acc_path,
                        sam_path=sam_path)


@dataclass
class AdenoDataset:
    dir: str
    nodes_path: str
    names_path: str
    fasta_path: str
    acc2taxid_path: str
    sam_path: str


def build_adeno_db(ds: AdenoDataset):
    from slimm_jax.config import BuildOptions
    from slimm_jax.database import build_database

    return build_database(BuildOptions(
        fasta_path=ds.fasta_path, ac__taxid_paths=[ds.acc2taxid_path],
        names_path=ds.names_path, nodes_path=ds.nodes_path,
        output_path=os.path.join(ds.dir, "adeno.sldb")))


def oracle_state(ds: AdenoDataset, db, options=None):
    from slimm_jax.config import ProfileOptions
    from slimm_jax.io import AlignmentFile
    from slimm_jax.oracle import OracleProfiler

    af = AlignmentFile(ds.sam_path)
    prof = OracleProfiler(options or ProfileOptions(), db.ac__taxid,
                          db.taxid__name,
                          list(zip(af.contig_names,
                                   af.contig_lengths.tolist())))
    return prof.run(af.raw_records())


def write_reports(state, out_dir: str, sam_path: str) -> list[str]:
    from slimm_jax.engine.reports import (write_abundance, write_coverage,
                                          write_raw_stat)

    paths = [write_abundance(state, out_dir + "/", sam_path),
             write_raw_stat(state, out_dir + "/", sam_path)]
    paths += write_coverage(state, out_dir + "/", sam_path)
    return paths


def main():
    """Regenerate the committed golden TSVs from the oracle."""
    import sys
    import tempfile

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory() as d:
        ds = write_inputs(d)
        db = build_adeno_db(ds)
        st = oracle_state(ds, db)
        paths = write_reports(st, GOLDEN_DIR, ds.sam_path)
    for p in paths:
        print("wrote", p)


if __name__ == "__main__":
    main()
