import os

import pytest

from slimm_jax.cli import main

from tests.toy import build_toy_dataset


@pytest.fixture(scope="module")
def built_db(toy_dir):
    out = os.path.join(toy_dir.dir, "cli.sldb")
    rc = main(["build", "-nm", toy_dir.names_path, "-nd", toy_dir.nodes_path,
               "-o", out, toy_dir.fasta_path, toy_dir.acc2taxid_path])
    assert rc == 0
    return out


def test_build_outputs(built_db):
    assert os.path.exists(built_db)
    assert os.path.exists(built_db + ".npz")


def test_profile_end_to_end(built_db, toy_dir, tmp_path):
    out_prefix = str(tmp_path) + "/"
    rc = main(["profile", "-o", out_prefix, built_db, toy_dir.sam_path])
    assert rc == 0
    profile = tmp_path / "toy-reads_profile.tsv"
    assert profile.exists()
    lines = profile.read_text().splitlines()
    assert lines[0] == "taxa_level\ttaxa_id\tlinage\tabundance\tread_count"
    assert lines[-1].startswith("species\t0*\t")
    taxids = [ln.split("\t")[1] for ln in lines[1:]]
    for tid in ("562", "622", "1396"):
        assert tid in taxids


def test_profile_engine_equals_oracle_cli(built_db, toy_dir, tmp_path):
    eng = str(tmp_path / "eng") + "/"
    orc = str(tmp_path / "orc") + "/"
    os.makedirs(eng), os.makedirs(orc)
    assert main(["profile", "-o", eng, built_db, toy_dir.sam_path]) == 0
    assert main(["profile", "--no-device", "-o", orc, built_db,
                 toy_dir.sam_path]) == 0
    e = open(os.path.join(eng, "toy-reads_profile.tsv")).read()
    o = open(os.path.join(orc, "toy-reads_profile.tsv")).read()
    assert e == o


def test_profile_raw_and_coverage_outputs(built_db, toy_dir, tmp_path):
    out = str(tmp_path) + "/"
    rc = main(["profile", "-ro", "-co", "-v", "-o", out, built_db,
               toy_dir.sam_path])
    assert rc == 0
    assert (tmp_path / "toy-reads_raw.tsv").exists()
    for suffix in ("_coverage", "_uniq_coverage", "_uniq_coverage2"):
        assert (tmp_path / f"toy-reads{suffix}.tsv").exists()
    raw = (tmp_path / "toy-reads_raw.tsv").read_text().splitlines()
    assert raw[0].startswith("accesion\ttaxaid\tname")   # reference spelling
    assert len(raw) == 1 + len(toy_dir.contigs)


def test_profile_directory_mode(built_db, toy_dir, tmp_path):
    import shutil
    indir = tmp_path / "in"
    indir.mkdir()
    shutil.copy(toy_dir.sam_path, indir / "s1.sam")
    shutil.copy(toy_dir.sam_path, indir / "s2.sam")
    out = str(tmp_path / "out") + "/"
    os.makedirs(out)
    rc = main(["profile", "-d", "-o", out, built_db, str(indir)])
    assert rc == 0
    assert (tmp_path / "out" / "s1_profile.tsv").exists()
    assert (tmp_path / "out" / "s2_profile.tsv").exists()


def test_collect(built_db, toy_dir, tmp_path):
    out = str(tmp_path) + "/"
    main(["profile", "-o", out, built_db, toy_dir.sam_path])
    import shutil
    p = str(tmp_path / "toy-reads_profile.tsv")
    p1 = str(tmp_path / "s1_profile.tsv")
    p2 = str(tmp_path / "s2_profile.tsv")
    shutil.copy(p, p1), shutil.copy(p, p2)
    merged = str(tmp_path / "merged_profile.tsv")
    rc = main(["collect", "-o", merged, p1, p2])
    assert rc == 0
    lines = open(merged).read().splitlines()
    assert lines[0].split("\t") == ["level", "taxid", "name", "linage",
                                    "s1_profile", "s2_profile"]
    assert len(lines) > 2
    # per-sample columns carry the read counts (reference quirk)
    first = lines[1].split("\t")
    assert first[4] == first[5]


def test_cov_cutoff_range_rejected(built_db, toy_dir):
    with pytest.raises(SystemExit):
        main(["profile", "-cc", "1.5", built_db, toy_dir.sam_path])


def test_version():
    with pytest.raises(SystemExit) as e:
        main(["--version"])
    assert e.value.code == 0


def test_profile_json_stats(built_db, toy_dir, tmp_path):
    import json
    import os

    out_prefix = os.path.join(str(tmp_path), "js_")
    stats_path = os.path.join(str(tmp_path), "stats.jsonl")
    rc = main(["profile", "-o", out_prefix, "--json-stats", stats_path,
               built_db, toy_dir.sam_path])
    assert rc == 0
    rows = [json.loads(l) for l in open(stats_path)]
    assert len(rows) == 1
    r = rows[0]
    assert r["file"] == toy_dir.sam_path
    assert r["hits_count"] > 0
    assert r["matches_count"] > 0
    assert 0.0 <= r["coverage_cut_off"] <= 1.0
    # every counter equals the scalar oracle's
    orc_stats = os.path.join(str(tmp_path), "orc.jsonl")
    assert main(["profile", "--no-device", "-o", out_prefix, "--json-stats",
                 orc_stats, built_db, toy_dir.sam_path]) == 0
    (o,) = [json.loads(l) for l in open(orc_stats)]
    assert r == o
    assert r["lca_reads"] > 0 and r["cov_mass"] > 0


def test_profile_corrupt_input_exits_1(built_db, toy_dir, tmp_path, capsys):
    # corrupt input -> "[ERROR] ..." + exit code 1, not a traceback
    # (SeqAn's global exception handler surface, src/CMakeLists.txt:150)
    from tests.toy import bgzf_compress, make_bam_body

    data = bgzf_compress(make_bam_body(toy_dir.records))
    bad = tmp_path / "bad.bam"
    bad.write_bytes(data[:len(data) // 2])
    from slimm_jax.cli import main
    rc = main(["profile", "-o", str(tmp_path / "o"), built_db, str(bad)])
    assert rc == 1
    assert "[ERROR]" in capsys.readouterr().err


def test_profile_missing_db_exits_1(toy_dir, tmp_path, capsys):
    from slimm_jax.cli import main
    rc = main(["profile", "-o", str(tmp_path / "o"),
               str(tmp_path / "nope.sldb"), toy_dir.sam_path])
    assert rc == 1
    assert "[ERROR]" in capsys.readouterr().err


def test_profile_scaleout_flags_identical_tsv(built_db, toy_dir, tmp_path):
    # the scale-out CLI surface: --shards/--model-shards (2-D mesh) and
    # --stream (chunked decode+profile) must produce byte-identical
    # profiles to the plain single-device run
    plain = str(tmp_path / "plain") + "/"
    sh = str(tmp_path / "sh") + "/"
    stream = str(tmp_path / "st") + "/"
    for d in (plain, sh, stream):
        os.makedirs(d)
    assert main(["profile", "-o", plain, built_db, toy_dir.sam_path]) == 0
    assert main(["profile", "--shards", "2", "--model-shards", "2",
                 "-o", sh, built_db, toy_dir.sam_path]) == 0
    assert main(["profile", "--stream", "600", "-o", stream, built_db,
                 toy_dir.sam_path]) == 0
    ref = open(os.path.join(plain, "toy-reads_profile.tsv")).read()
    assert open(os.path.join(sh, "toy-reads_profile.tsv")).read() == ref
    assert open(os.path.join(stream, "toy-reads_profile.tsv")).read() == ref


def test_compile_cache_honours_env_dir(built_db, toy_dir, tmp_path):
    # JAX_COMPILATION_CACHE_DIR set: the CLI's compiled programs land there
    import subprocess
    import sys

    cache = tmp_path / "x"
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(cache),
               JAX_ENABLE_COMPILATION_CACHE="true",
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "slimm_jax", "profile", "-o",
                        str(tmp_path / "o") + "/", built_db,
                        toy_dir.sam_path], env=env, cwd=repo,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    assert cache.is_dir() and any(cache.iterdir())


def test_compile_cache_defaults_to_checkout(built_db, toy_dir, tmp_path,
                                            monkeypatch):
    # JAX_COMPILATION_CACHE_DIR unset: <checkout>/.jax_cache
    import jax

    from slimm_jax.utils.compile_cache import DEFAULT_CACHE_DIR

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert DEFAULT_CACHE_DIR == os.path.join(repo, ".jax_cache")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert main(["profile", "-o", str(tmp_path) + "/", built_db,
                     toy_dir.sam_path]) == 0
        assert jax.config.jax_compilation_cache_dir == DEFAULT_CACHE_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
