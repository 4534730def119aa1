"""Golden-output harness on the reference's own example data (SURVEY.md
§4 item 1).

The committed TSVs under tests/golden/ were produced by the scalar oracle
over a deterministic fixture built from /root/reference/tests/example/
adeno-genome.fa (see tests/golden_adeno.py).  Every execution mode must
reproduce those bytes exactly: the oracle (guards against oracle drift),
the fused device engine, and the sharded streaming engine."""

import copy
import filecmp
import os

import pytest

from slimm_jax.config import EngineOptions, ProfileOptions

from tests import golden_adeno as GA

GOLDEN_FILES = ["adeno-reads_profile.tsv", "adeno-reads_raw.tsv",
                "adeno-reads_coverage.tsv", "adeno-reads_uniq_coverage.tsv",
                "adeno-reads_uniq_coverage2.tsv"]

pytestmark = pytest.mark.skipif(
    not os.path.exists(GA.REFERENCE_FASTA),
    reason="reference example data not available")


@pytest.fixture(scope="module")
def adeno(tmp_path_factory):
    d = tmp_path_factory.mktemp("adeno")
    ds = GA.write_inputs(str(d))
    db = GA.build_adeno_db(ds)
    return ds, db


def _assert_matches_golden(state, ds, tmp_path, tag):
    out_dir = str(tmp_path / tag)
    GA.write_reports(state, out_dir, ds.sam_path)
    for name in GOLDEN_FILES:
        got = os.path.join(out_dir, name)
        want = os.path.join(GA.GOLDEN_DIR, name)
        assert filecmp.cmp(got, want, shallow=False), (
            f"{name} differs from the committed golden bytes:\n"
            f"--- got ---\n{open(got).read()}\n"
            f"--- want ---\n{open(want).read()}")


def test_oracle_reproduces_golden_bytes(adeno, tmp_path):
    ds, db = adeno
    opts = ProfileOptions(raw_output=True, coverage_output=True)
    st = GA.oracle_state(ds, copy.deepcopy(db), opts)
    _assert_matches_golden(st, ds, tmp_path, "oracle")


def test_engine_reproduces_golden_bytes(adeno, tmp_path):
    from slimm_jax.engine import profile_file

    ds, db = adeno
    opts = ProfileOptions(raw_output=True, coverage_output=True)
    st = profile_file(opts, copy.deepcopy(db), ds.sam_path,
                      engine=EngineOptions(phase_log=False))
    _assert_matches_golden(st, ds, tmp_path, "engine")


def test_streaming_sharded_reproduces_golden_bytes(adeno, tmp_path):
    from slimm_jax.engine.pipeline import profile_file_streaming
    from slimm_jax.io import native
    from slimm_jax.parallel import ShardedRunner

    if not native.available():
        pytest.skip("native decoder not built")
    ds, db = adeno
    opts = ProfileOptions(raw_output=True, coverage_output=True)
    st = profile_file_streaming(
        opts, copy.deepcopy(db), ds.sam_path,
        engine=EngineOptions(phase_log=False), chunk_targets=64,
        sharded_runner=ShardedRunner(num_shards=4, model_shards=2))
    _assert_matches_golden(st, ds, tmp_path, "stream")


def test_golden_db_roundtrip(adeno, tmp_path):
    # the .sldb written for the adeno fixture reloads losslessly
    from slimm_jax.database import SlimmDatabase

    ds, db = adeno
    p = str(tmp_path / "adeno.sldb")
    db.save_sldb(p)
    db2 = SlimmDatabase.load(p)
    assert db2.ac__taxid == db.ac__taxid
    assert db2.taxid__name == db.taxid__name
