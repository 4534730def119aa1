"""Synthetic toy dataset: taxonomy dmp files, FASTA, acc2taxid, and a SAM
file with known structure (golden-harness input, SURVEY.md §4).

Taxa: two phyla of Bacteria; Escherichia coli (2 strains, one with 2
contigs), Shigella (same family as E. coli), and Bacillus (other phylum).
Reads exercise: unique hits, multimaps resolving at species / family /
superkingdom LCA levels, repeated same-contig hits (first-hit-wins),
read pairs (.1/.2 keys), unmapped records, and records on contigs absent
from the DB.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

# taxid: (parent, rank, name)
TOY_TAXONOMY = {
    1: (1, "no rank", "root"),
    2: (131567, "superkingdom", "Bacteria"),
    131567: (1, "no rank", "cellular organisms"),
    1224: (2, "phylum", "Proteobacteria"),
    1236: (1224, "class", "Gammaproteobacteria"),
    91347: (1236, "order", "Enterobacterales"),
    543: (91347, "family", "Enterobacteriaceae"),
    561: (543, "genus", "Escherichia"),
    562: (561, "species", "Escherichia coli"),
    100001: (562, "no rank", "Escherichia coli K-12"),
    100002: (562, "no rank", "Escherichia coli O157"),
    620: (543, "genus", "Shigella"),
    622: (620, "species", "Shigella dysenteriae"),
    100003: (622, "no rank", "Shigella dysenteriae Sd197"),
    1239: (2, "phylum", "Firmicutes"),
    91061: (1239, "class", "Bacilli"),
    1385: (91061, "order", "Bacillales"),
    186817: (1385, "family", "Bacillaceae"),
    1386: (186817, "genus", "Bacillus"),
    1396: (1386, "species", "Bacillus cereus"),
    100004: (1396, "no rank", "Bacillus cereus ATCC"),
}

# accession (versionless) → (version-suffixed sequence name, length, strain taxid)
TOY_CONTIGS = [
    ("NC_000001", "NC_000001.1", 9000, 100001),   # E. coli K-12 chromosome
    ("NC_000002", "NC_000002.1", 4000, 100001),   # E. coli K-12 plasmid
    ("NC_000003", "NC_000003.1", 8000, 100002),   # E. coli O157
    ("NC_000004", "NC_000004.1", 7000, 100003),   # Shigella
    ("NC_000005", "NC_000005.1", 6000, 100004),   # Bacillus
    ("NC_000099", "NC_000099.1", 3000, 0),        # not in the DB (no taxid)
]

READ_LEN = 100


def write_taxonomy_files(d: str):
    nodes_path = os.path.join(d, "nodes.dmp")
    names_path = os.path.join(d, "names.dmp")
    with open(nodes_path, "wt") as f:
        for tid, (parent, rank, _) in sorted(TOY_TAXONOMY.items()):
            f.write(f"{tid}\t|\t{parent}\t|\t{rank}\t|\t\t|\n")
    with open(names_path, "wt") as f:
        for tid, (_, _, name) in sorted(TOY_TAXONOMY.items()):
            f.write(f"{tid}\t|\t{name}\t|\t\t|\tscientific name\t|\n")
    return nodes_path, names_path


def write_fasta_and_acc2taxid(d: str):
    fasta_path = os.path.join(d, "toy-genomes.fa")
    acc_path = os.path.join(d, "toy.accession2taxid")
    rng = np.random.default_rng(7)
    with open(fasta_path, "wt") as f:
        for acc, seq_name, length, _ in TOY_CONTIGS:
            f.write(f">{seq_name} toy genome\n")
            seq = "".join(rng.choice(list("ACGT"), size=200))
            f.write(seq + "\n")
    with open(acc_path, "wt") as f:
        f.write("accession\taccession.version\ttaxid\tgi\n")
        for acc, seq_name, _, taxid in TOY_CONTIGS:
            if taxid:
                f.write(f"{acc}\t{seq_name}\t{taxid}\t0\n")
    return fasta_path, acc_path


def make_records(n_extra: int = 0, seed: int = 0):
    """Deterministic alignment records: (qname, flag, rid, pos0, seq_len)."""
    rng = np.random.default_rng(seed)
    lengths = [c[2] for c in TOY_CONTIGS]
    records = []

    def spread(rid, count, prefix, flag=0):
        for k in range(count):
            pos = int(rng.integers(0, max(1, lengths[rid] - READ_LEN)))
            records.append((f"{prefix}{k}", flag, rid, pos, READ_LEN))

    # unique reads per contig — enough coverage to pass filtering
    spread(0, 120, "u_k12a_")
    spread(1, 50, "u_k12b_")
    spread(2, 90, "u_o157_")
    spread(3, 70, "u_shig_")
    spread(4, 60, "u_bac_")
    spread(5, 10, "u_unk_")          # contig not in the DB

    # multimapped: across the two K-12 contigs (LCA at strain taxid 100001)
    for k in range(25):
        records.append((f"m_strain_{k}", 0, 0, int(rng.integers(0, 8900)), READ_LEN))
        records.append((f"m_strain_{k}", 0, 1, int(rng.integers(0, 3900)), READ_LEN))
    # across E. coli strains (LCA at species 562)
    for k in range(30):
        records.append((f"m_species_{k}", 0, 0, int(rng.integers(0, 8900)), READ_LEN))
        records.append((f"m_species_{k}", 0, 2, int(rng.integers(0, 7900)), READ_LEN))
    # E. coli vs Shigella (LCA at family 543)
    for k in range(20):
        records.append((f"m_family_{k}", 0, 2, int(rng.integers(0, 7900)), READ_LEN))
        records.append((f"m_family_{k}", 0, 3, int(rng.integers(0, 6900)), READ_LEN))
    # cross-phylum (LCA at superkingdom 2)
    for k in range(10):
        records.append((f"m_king_{k}", 0, 0, int(rng.integers(0, 8900)), READ_LEN))
        records.append((f"m_king_{k}", 0, 4, int(rng.integers(0, 5900)), READ_LEN))
    # repeated same-contig hits: only the FIRST position may count
    for k in range(15):
        records.append((f"dup_{k}", 0, 3, 100 + 10 * k, READ_LEN))
        records.append((f"dup_{k}", 0, 3, 5000 + 10 * k, READ_LEN))
    # read pairs: same qname, .1/.2 keys are distinct reads
    for k in range(12):
        records.append((f"pair_{k}", 0x40, 0, int(rng.integers(0, 8900)), READ_LEN))
        records.append((f"pair_{k}", 0x80, 0, int(rng.integers(0, 8900)), READ_LEN))
    # unmapped records (skipped, but count toward avg read length)
    for k in range(8):
        records.append((f"unm_{k}", 0x4, -1, -1, READ_LEN))
    # extra random records for scale tests
    for k in range(n_extra):
        rid = int(rng.integers(0, 5))
        pos = int(rng.integers(0, max(1, lengths[rid] - READ_LEN)))
        records.append((f"x_{k}", 0, rid, pos, READ_LEN))
    return records


def write_sam(d: str, records, name: str = "toy-reads.sam"):
    sam_path = os.path.join(d, name)
    rng = np.random.default_rng(1)
    with open(sam_path, "wt") as f:
        f.write("@HD\tVN:1.6\tSO:unsorted\n")
        for _, seq_name, length, _ in TOY_CONTIGS:
            f.write(f"@SQ\tSN:{seq_name}\tLN:{length}\n")
        for qname, flag, rid, pos0, seq_len in records:
            rname = TOY_CONTIGS[rid][1] if rid >= 0 else "*"
            pos1 = pos0 + 1 if rid >= 0 else 0
            seq = "".join(rng.choice(list("ACGT"), size=seq_len)) if seq_len else "*"
            qual = "I" * seq_len if seq_len else "*"
            cigar = f"{seq_len}M" if rid >= 0 else "*"
            f.write(f"{qname}\t{flag}\t{rname}\t{pos1}\t60\t{cigar}\t*\t0\t0"
                    f"\t{seq}\t{qual}\n")
    return sam_path


# 28-byte empty BGZF block marking end-of-file (SAM spec §4.1.2)
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def bgzf_compress(data: bytes, block_payload: int = 0xff00,
                  eof_marker: bool = True) -> bytes:
    """True BGZF: gzip members with the BC extra subfield + EOF marker."""
    import struct
    import zlib

    out = bytearray()
    for i in range(0, len(data), block_payload) or [0]:
        chunk = data[i:i + block_payload]
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        cdata = co.compress(chunk) + co.flush()
        xlen = 6
        bsize = len(cdata) + 12 + xlen + 8
        assert bsize <= 0x10000, "BGZF block overflow"
        out += struct.pack("<BBBBIBBH", 0x1f, 0x8b, 8, 4, 0, 0, 0xff, xlen)
        out += struct.pack("<BBHH", 66, 67, 2, bsize - 1)   # BC subfield
        out += cdata
        out += struct.pack("<II", zlib.crc32(chunk) & 0xFFFFFFFF, len(chunk))
    if eof_marker:
        out += BGZF_EOF
    return bytes(out)


def make_bam_body(records) -> bytes:
    """Uncompressed BAM byte stream for the toy records."""
    import struct

    rng = np.random.default_rng(1)
    body = bytearray()
    body += b"BAM\x01"
    text = b""
    body += struct.pack("<i", len(text)) + text
    body += struct.pack("<i", len(TOY_CONTIGS))
    for _, seq_name, length, _ in TOY_CONTIGS:
        raw = seq_name.encode() + b"\x00"
        body += struct.pack("<i", len(raw)) + raw + struct.pack("<i", length)
    seq_code = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
    for qname, flag, rid, pos0, seq_len in records:
        qn = qname.encode() + b"\x00"
        seq = rng.choice(list("ACGT"), size=seq_len) if seq_len else []
        packed = bytearray()
        for i in range(0, len(seq), 2):
            hi = seq_code[seq[i]] << 4
            lo = seq_code[seq[i + 1]] if i + 1 < len(seq) else 0
            packed.append(hi | lo)
        cigar = struct.pack("<I", (seq_len << 4) | 0) if rid >= 0 else b""
        qual = b"\x28" * seq_len
        rec = struct.pack("<iiBBHHHiiii", rid, pos0 if rid >= 0 else -1,
                          len(qn), 60, 0, 1 if cigar else 0, flag, seq_len,
                          -1, -1, 0)
        rec += qn + cigar + bytes(packed) + qual
        body += struct.pack("<i", len(rec)) + rec
    return bytes(body)


def write_bam(d: str, records, name: str = "toy-reads.bam",
              container: str = "bgzf"):
    """BAM writer: proper BGZF container by default ("bgzf"); "gzip" writes
    a plain single-member gzip stream (legal input, exercises the streaming
    gzip path); "raw" writes the uncompressed BAM stream."""
    bam_path = os.path.join(d, name)
    body = make_bam_body(records)
    if container == "bgzf":
        data = bgzf_compress(body)
    elif container == "gzip":
        import gzip as _gzip
        data = _gzip.compress(body)
    elif container == "raw":
        data = body
    else:
        raise ValueError(container)
    with open(bam_path, "wb") as f:
        f.write(data)
    return bam_path


@dataclass
class ToyDataset:
    dir: str
    nodes_path: str
    names_path: str
    fasta_path: str
    acc2taxid_path: str
    sam_path: str
    records: list
    contigs: list  # [(seq_name, length)]


def build_toy_dataset(d: str, n_extra: int = 0, seed: int = 0) -> ToyDataset:
    nodes_path, names_path = write_taxonomy_files(d)
    fasta_path, acc_path = write_fasta_and_acc2taxid(d)
    records = make_records(n_extra=n_extra, seed=seed)
    sam_path = write_sam(d, records)
    return ToyDataset(
        dir=d, nodes_path=nodes_path, names_path=names_path,
        fasta_path=fasta_path, acc2taxid_path=acc_path, sam_path=sam_path,
        records=records, contigs=[(c[1], c[2]) for c in TOY_CONTIGS])


def build_toy_db(dataset: ToyDataset):
    from slimm_jax.config import BuildOptions
    from slimm_jax.database import build_database

    opts = BuildOptions(
        fasta_path=dataset.fasta_path,
        ac__taxid_paths=[dataset.acc2taxid_path],
        names_path=dataset.names_path,
        nodes_path=dataset.nodes_path,
        output_path=os.path.join(dataset.dir, "toy.sldb"))
    return build_database(opts)
