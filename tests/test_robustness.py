"""Decoder robustness: corrupt/truncated input must raise with context, and
malformed SAM lines must be counted — never a silently-wrong profile.

The reference (SeqAn) throws on malformed input (src/CMakeLists.txt:150
global handler, misc.hpp:498-507 open failures); both repo decoders replicate
that contract on true-BGZF, plain-gzip and raw containers.
"""

import numpy as np
import pytest

from slimm_jax.io import AlignmentFile, native

from tests.toy import (BGZF_EOF, bgzf_compress, make_bam_body, make_records,
                       write_bam, write_sam)


@pytest.fixture(scope="session", autouse=True)
def ensure_native_built():
    # available() builds the library from native/ on first use
    if not native.available():
        pytest.skip("native toolchain unavailable")


def _both_decoders(path):
    return [AlignmentFile, native.NativeAlignmentFile]


def assert_batches_equal(a, b):
    assert a.hits_count == b.hits_count
    assert a.n_reads == b.n_reads
    assert a.avg_read_length == b.avg_read_length
    np.testing.assert_array_equal(np.asarray(a.read_id, np.int64),
                                  np.asarray(b.read_id, np.int64))
    np.testing.assert_array_equal(a.rid, b.rid)
    np.testing.assert_array_equal(a.pos, b.pos)


# -- container matrix ---------------------------------------------------------


@pytest.mark.parametrize("container", ["bgzf", "gzip", "raw"])
def test_bam_containers_decode_identically(toy_dir, container):
    bam = write_bam(toy_dir.dir, toy_dir.records,
                    name=f"cont_{container}.bam", container=container)
    sam_batch = AlignmentFile(toy_dir.sam_path).load()
    for cls in (AlignmentFile, native.NativeAlignmentFile):
        assert_batches_equal(cls(bam).load(), sam_batch)


def test_gzipped_sam_decodes(toy_dir, tmp_path):
    import gzip

    sam_gz = tmp_path / "reads.sam.gz"
    sam_gz.write_bytes(gzip.compress(open(toy_dir.sam_path, "rb").read()))
    sam_batch = AlignmentFile(toy_dir.sam_path).load()
    for cls in (AlignmentFile, native.NativeAlignmentFile):
        assert_batches_equal(cls(str(sam_gz)).load(), sam_batch)


def test_bgzf_sam_decodes(toy_dir, tmp_path):
    sam_bgzf = tmp_path / "reads.sam.bgzf"
    sam_bgzf.write_bytes(bgzf_compress(open(toy_dir.sam_path, "rb").read()))
    sam_batch = AlignmentFile(toy_dir.sam_path).load()
    for cls in (AlignmentFile, native.NativeAlignmentFile):
        assert_batches_equal(cls(str(sam_bgzf)).load(), sam_batch)


# -- corruption ----------------------------------------------------------------


def _write(tmp_path, name, data):
    p = tmp_path / name
    p.write_bytes(data)
    return str(p)


def test_truncated_bgzf_block_raises(toy_dir, tmp_path):
    data = bgzf_compress(make_bam_body(toy_dir.records))
    p = _write(tmp_path, "trunc.bam", data[:len(data) // 2])
    with pytest.raises(ValueError, match="truncated|BGZF|BAM stream"):
        native.NativeAlignmentFile(p).load()
    with pytest.raises(ValueError):
        AlignmentFile(p)


def test_corrupt_bgzf_payload_raises(toy_dir, tmp_path):
    data = bytearray(bgzf_compress(make_bam_body(toy_dir.records)))
    # flip bytes in the middle of the first block's deflate payload
    for i in range(40, 60):
        data[i] ^= 0xFF
    p = _write(tmp_path, "corrupt.bam", bytes(data))
    with pytest.raises(ValueError, match="BGZF|gzip|BAM"):
        native.NativeAlignmentFile(p).load()
    with pytest.raises(ValueError):
        AlignmentFile(p)


def test_truncated_bam_record_raises(toy_dir, tmp_path):
    # valid BGZF container around a truncated BAM body: the record-level
    # parser must flag it (the container checks can't)
    body = make_bam_body(toy_dir.records)
    p = _write(tmp_path, "truncrec.bam", bgzf_compress(body[:-37]))
    with pytest.raises(ValueError, match="truncated BAM"):
        native.NativeAlignmentFile(p).load()
    with pytest.raises(ValueError, match="truncated BAM"):
        AlignmentFile(p)


def test_corrupt_bam_block_size_raises(toy_dir, tmp_path):
    import struct

    body = bytearray(make_bam_body(toy_dir.records[:5]))
    # find the first record (after magic+header+refs) and wreck block_size
    off = 4
    (l_text,) = struct.unpack_from("<i", body, off)
    off += 4 + l_text
    (n_ref,) = struct.unpack_from("<i", body, off)
    off += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", body, off)
        off += 4 + l_name + 4
    struct.pack_into("<i", body, off, -5)
    p = _write(tmp_path, "badsize.bam", bgzf_compress(bytes(body)))
    with pytest.raises(ValueError, match="record size"):
        native.NativeAlignmentFile(p).load()
    with pytest.raises(ValueError, match="record size"):
        AlignmentFile(p)


def test_missing_bgzf_eof_marker_warns(toy_dir, tmp_path, capsys):
    body = make_bam_body(toy_dir.records)
    p = _write(tmp_path, "noeof.bam",
               bgzf_compress(body, eof_marker=False))
    nat = native.NativeAlignmentFile(p)  # decodes fine, but warns
    err = capsys.readouterr().err
    assert "missing BGZF EOF marker" in err
    sam_batch = AlignmentFile(toy_dir.sam_path).load()
    assert_batches_equal(nat.load(), sam_batch)


def test_malformed_sam_lines_counted(toy_dir, tmp_path, capsys):
    sam = write_sam(str(tmp_path), toy_dir.records, name="mal.sam")
    with open(sam, "at") as f:
        f.write("broken line without tabs\n")
        f.write("only\tthree\tfields\n")
    good = AlignmentFile(toy_dir.sam_path).load()
    for cls in (AlignmentFile, native.NativeAlignmentFile):
        af = cls(sam)
        assert af.n_malformed == 2
        assert_batches_equal(af.load(), good)
    assert "malformed" in capsys.readouterr().err


def test_truncated_gzip_stream_raises(toy_dir, tmp_path):
    import gzip

    data = gzip.compress(make_bam_body(toy_dir.records))
    p = _write(tmp_path, "truncgz.bam", data[:len(data) - 20])
    with pytest.raises(ValueError, match="truncated|gzip|BAM"):
        native.NativeAlignmentFile(p).load()
    with pytest.raises(ValueError):
        AlignmentFile(p)


def test_bgzf_roundtrip_bytes(tmp_path):
    # the fixture writer itself: block split + EOF marker + CRC correctness
    import gzip

    payload = bytes(np.random.default_rng(3).integers(
        0, 256, 200_000, dtype=np.uint8))
    data = bgzf_compress(payload)
    assert data.endswith(BGZF_EOF)
    assert gzip.decompress(data) == payload
