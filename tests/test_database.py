import os

import numpy as np

from slimm_jax.database import SlimmDatabase, build_database, tensorize
from slimm_jax.config import BuildOptions
from slimm_jax.taxonomy import LINEAGE_LENGTH, Rank

from tests.toy import TOY_CONTIGS, build_toy_db


def test_build_database_lineages(toy_dir):
    db = build_toy_db(toy_dir)
    # E. coli K-12 contig: strain 100001 → species 562 → genus 561 →
    # family 543 → order 91347 → class 1236 → phylum 1224 → superkingdom 2
    lin = db.ac__taxid["NC_000001"]
    assert lin == [100001, 562, 561, 543, 91347, 1236, 1224, 2]
    # Bacillus
    assert db.ac__taxid["NC_000005"] == [100004, 1396, 1386, 186817, 1385,
                                         91061, 1239, 2]
    # names + ranks recorded for every lineage taxid (slimm_build.cpp:326-345)
    assert db.taxid__name[562] == (int(Rank.SPECIES), "Escherichia coli")
    assert db.taxid__name[2] == (int(Rank.SUPERKINGDOM), "Bacteria")
    assert db.taxid__name[100001] == (int(Rank.STRAIN), "Escherichia coli K-12")
    # unresolved accession is NOT in the DB
    assert "NC_000099" not in db.ac__taxid


def test_build_database_missed_file(toy_dir):
    build_toy_db(toy_dir)
    # substr(0, size-4) + "missed" (slimm_build.cpp:204-205): keeps the dot
    missed = os.path.join(toy_dir.dir, "toy.missed")
    assert os.path.exists(missed)
    assert open(missed).read().strip() == "NC_000099"


def test_build_database_native_matches_python(toy_dir):
    # the C++ acc2taxid scanner and the python batch loop must build the
    # exact same DB (incl. the missed set)
    from slimm_jax.io import native as native_mod
    if not native_mod.available():
        import pytest
        pytest.skip("native library not built")
    opts = dict(fasta_path=toy_dir.fasta_path,
                ac__taxid_paths=[toy_dir.acc2taxid_path],
                names_path=toy_dir.names_path, nodes_path=toy_dir.nodes_path,
                output_path=os.path.join(toy_dir.dir, "toy.sldb"))
    db_n = build_database(BuildOptions(**opts, use_native=True))
    db_p = build_database(BuildOptions(**opts, use_native=False))
    assert db_n.ac__taxid == db_p.ac__taxid
    assert db_n.taxid__name == db_p.taxid__name


def test_native_acc2taxid_scan_semantics(tmp_path):
    # reference batch semantics (slimm_build.cpp:175-278): last occurrence
    # within a batch wins, resolution freezes at the batch boundary, parse
    # failures yield 0, early exit once everything resolved
    from slimm_jax.io import native as native_mod
    if not native_mod.available():
        import pytest
        pytest.skip("native library not built")
    p = str(tmp_path / "map.tsv")
    with open(p, "w") as f:
        f.write("accession\taccession.version\ttaxid\tgi\n")
        f.write("A1\tA1.1\t100\t0\n")
        f.write("A2\tA2.1\t200\t0\n")
        f.write("A2\tA2.1\t250\t0\n")   # same batch: last wins
        f.write("A3\tA3.1\tbogus\t0\n")  # int() failure -> 0
        f.write("A4\tA4.1\n")            # no taxid column -> 0
        f.write("A6\tA6.1\t 600 x\t0\n")  # split()[0] == "600"
        f.write("A2\tA2.1\t999\t0\n")
    from slimm_jax.database import stream_acc2taxid_batches
    for batch in (1000000, 3, 1):
        out = native_mod.acc2taxid_scan(
            p, ["A1", "A2", "A3", "A4", "A6", "MISSING"], batch)
        accs = {"A1", "A2", "A3", "A4", "A6", "MISSING"}
        ref = {}
        for b in stream_acc2taxid_batches(p, batch):
            found = accs & b.keys()
            for a in found:
                ref[a] = b[a]
            accs -= found
        assert out == ref, f"batch={batch}"
        assert "MISSING" not in out


def test_sldb_round_trip(toy_dir, tmp_path):
    db = build_toy_db(toy_dir)
    path = str(tmp_path / "rt.sldb")
    db.save_sldb(path)
    db2 = SlimmDatabase.load_sldb(path)
    assert db2.ac__taxid == db.ac__taxid
    assert db2.taxid__name == db.taxid__name


def test_sldb_binary_layout(tmp_path):
    # spot-check the cereal byte layout: counts are uint64, strings are
    # uint64-length-prefixed, vectors are uint64-size + raw uint32 data
    db = SlimmDatabase(
        ac__taxid={"AB": [1, 2, 3, 4, 5, 6, 7, 8]},
        taxid__name={9: (1, "x")})
    path = str(tmp_path / "layout.sldb")
    db.save_sldb(path)
    raw = open(path, "rb").read()
    import struct
    assert struct.unpack_from("<Q", raw, 0)[0] == 1          # map size
    assert struct.unpack_from("<Q", raw, 8)[0] == 2          # key length
    assert raw[16:18] == b"AB"
    assert struct.unpack_from("<Q", raw, 18)[0] == 8         # vector size
    assert np.frombuffer(raw, "<u4", 8, 26).tolist() == [1, 2, 3, 4, 5, 6, 7, 8]
    off = 26 + 32
    assert struct.unpack_from("<Q", raw, off)[0] == 1        # 2nd map size
    taxid, rank, slen = struct.unpack_from("<IiQ", raw, off + 8)
    assert (taxid, rank, slen) == (9, 1, 1)
    assert raw[off + 24:off + 25] == b"x"
    assert len(raw) == off + 25


def test_npz_cache_round_trip(toy_dir, tmp_path):
    db = build_toy_db(toy_dir)
    sldb = str(tmp_path / "c.sldb")
    db.save_sldb(sldb)
    db.save_npz(sldb + ".npz")
    db3 = SlimmDatabase.load(sldb)  # prefers the .npz cache
    assert db3.ac__taxid == db.ac__taxid
    assert db3.taxid__name == db.taxid__name


def test_tensorize(toy_dir):
    db = build_toy_db(toy_dir)
    names = [c[1] for c in TOY_CONTIGS]
    dt = tensorize(db, names)
    assert dt.lineage.shape == (len(names), LINEAGE_LENGTH)
    # dense id 0 is taxid 0
    assert dt.dense_to_tid[0] == 0
    # round-trip: dense lineage maps back to the original taxids
    back = dt.dense_to_tid[dt.lineage]
    assert back[0].tolist() == [100001, 562, 561, 543, 91347, 1236, 1224, 2]
    # unknown contig → all-zero lineage, and inserted into the live db map
    assert back[5].tolist() == [0] * 8
    assert db.ac__taxid["NC_000099"] == [0] * 8
    # ranks
    assert dt.tid_rank[dt.dense_of(562)] == int(Rank.SPECIES)
    assert dt.tid_rank[dt.dense_of(2)] == int(Rank.SUPERKINGDOM)


def test_acc2taxid_header_line_parses_as_zero(tmp_path):
    # the reference does not skip the header; a failed int parse yields 0
    p = tmp_path / "m.acc2taxid"
    p.write_text("accession\taccession.version\ttaxid\tgi\nA1\tA1.1\t42\t0\n")
    from slimm_jax.database import stream_acc2taxid_batches
    batches = list(stream_acc2taxid_batches(str(p), 10))
    assert batches == [{"accession": 0, "A1": 42}]


def _native_or_skip():
    import pytest

    from slimm_jax.io import native
    if not native.available():
        pytest.skip("native library not built")
    return native


def test_sldb_native_roundtrip_byte_identical(toy_dir, tmp_path):
    # cross-validation of the cereal binary layout by a SECOND, independent
    # implementation: the C++ reader/writer (native/slimm_native.cpp
    # stpu_sldb_roundtrip, derived from the cereal 1.x spec) must parse the
    # Python-written .sldb and reproduce it byte-for-byte
    native = _native_or_skip()
    db = build_toy_db(toy_dir)
    p_in = str(tmp_path / "py.sldb")
    p_out = str(tmp_path / "cpp.sldb")
    db.save_sldb(p_in)
    native.sldb_roundtrip(p_in, p_out)
    assert open(p_in, "rb").read() == open(p_out, "rb").read()


def test_sldb_golden_bytes(tmp_path):
    # hand-derived golden fixture from the cereal 1.x binary spec
    # (unordered_map: uint64 count + pairs; string: uint64 len + bytes;
    # vector<uint32>: uint64 size + raw; tuple: elements in order; enum as
    # underlying int32) — pins BOTH implementations to the documented format
    native = _native_or_skip()
    db = SlimmDatabase(ac__taxid={"A1": [7, 0, 0, 0, 0, 0, 0, 2]},
                       taxid__name={7: (0, "x"), 2: (7, "Bacteria")})
    p = str(tmp_path / "g.sldb")
    db.save_sldb(p)
    golden = (
        "0100000000000000"              # ac__taxid count = 1
        "0200000000000000" "4131"       # "A1"
        "0800000000000000"              # lineage size = 8
        "07000000" "00000000" "00000000" "00000000"
        "00000000" "00000000" "00000000" "02000000"
        "0200000000000000"              # taxid__name count = 2
        "07000000" "00000000"           # taxid 7, rank 0 (strain)
        "0100000000000000" "78"         # "x"
        "02000000" "07000000"           # taxid 2, rank 7 (superkingdom)
        "0800000000000000" "4261637465726961"  # "Bacteria"
    )
    assert open(p, "rb").read() == bytes.fromhex(golden)
    out = str(tmp_path / "g2.sldb")
    native.sldb_roundtrip(p, out)
    assert open(out, "rb").read() == bytes.fromhex(golden)


def test_sldb_native_rejects_corrupt(tmp_path):
    import pytest

    native = _native_or_skip()
    db = SlimmDatabase(ac__taxid={"A1": [1] * 8},
                       taxid__name={1: (0, "n")})
    p = str(tmp_path / "c.sldb")
    db.save_sldb(p)
    raw = bytearray(open(p, "rb").read())
    with pytest.raises(ValueError, match="truncated"):
        trunc = str(tmp_path / "t.sldb")
        open(trunc, "wb").write(bytes(raw[:-5]))
        native.sldb_roundtrip(trunc, str(tmp_path / "t2.sldb"))
    with pytest.raises(ValueError, match="trailing"):
        extra = str(tmp_path / "e.sldb")
        open(extra, "wb").write(bytes(raw) + b"zz")
        native.sldb_roundtrip(extra, str(tmp_path / "e2.sldb"))
