"""Real multi-process jax.distributed execution.

Spawns 2 OS processes that initialize the distributed runtime on CPU (2
virtual devices each) and profile host-sharded reads through
MultiHostRunner over the global 4-device mesh.  The merged rows must be
bit-identical to the single-process engine — this exercises
process_allgather, make_array_from_process_local_data, and the cross-host
plan sync for real.
"""

import copy
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "_mp_child.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_matches_single(tmp_path):
    port = _free_port()
    out_tsv = str(tmp_path / "mp_rows.tsv")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS",)}
    procs = [
        subprocess.Popen(
            [sys.executable, CHILD, f"127.0.0.1:{port}", "2", str(pid),
             str(tmp_path), out_tsv],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=REPO)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multi-process run timed out:\n" + "\n".join(outs))
    if any("UNSUPPORTED" in o for o in outs):
        pytest.skip("jax.distributed multi-process CPU unsupported here:\n"
                    + outs[0][-500:])
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
    assert os.path.exists(out_tsv), outs[0]

    # single-process reference rows
    from slimm_jax.config import EngineOptions, ProfileOptions
    from slimm_jax.engine import profile_file
    from tests.toy import build_toy_dataset, build_toy_db

    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    ds = build_toy_dataset(str(ref_dir))
    db = build_toy_db(ds)
    st = profile_file(ProfileOptions(), copy.deepcopy(db), ds.sam_path,
                      engine=EngineOptions(phase_log=False))
    expected = ["\t".join(r) for r in st.abundance_rows()]
    got = open(out_tsv).read().splitlines()
    assert got == expected

    # streaming x multi-host leg: each process streamed its own read
    # slice in chunks; merged rows must still be bit-identical
    if os.path.exists(out_tsv + ".stream"):
        got_stream = open(out_tsv + ".stream").read().splitlines()
        assert got_stream == expected
    else:
        assert any("NO-NATIVE" in o for o in outs), outs[0]
