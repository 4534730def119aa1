"""Child process for the multi-process jax.distributed test.

Usage: python tests/_mp_child.py <coordinator> <num_processes> <process_id>
       <work_dir> <out_tsv>

Each process initializes the distributed runtime on CPU (2 local virtual
devices), builds its own copy of the deterministic toy dataset, decodes the
SAM, keeps only ITS reads (global read id mod num_processes, renumbered
host-locally), and runs the fused profile through MultiHostRunner over the
global 2*num_processes-device mesh.  Process 0 writes the abundance rows;
all merged quantities are integer psums, so the rows must be bit-identical
to a single-process run.
"""

import os
import sys


def main():
    coordinator, n_proc, pid, work_dir, out_tsv = sys.argv[1:6]
    n_proc, pid = int(n_proc), int(pid)

    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    flags = " ".join(f for f in flags.split()
                     if "host_platform_device_count" not in f)
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=2").strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    try:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=n_proc, process_id=pid)
    except Exception as e:  # runtime without multi-process CPU support
        print(f"UNSUPPORTED: {e}", flush=True)
        return 3

    import copy

    import numpy as np

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)

    from tests.toy import build_toy_dataset, build_toy_db
    from slimm_jax.config import EngineOptions, ProfileOptions
    from slimm_jax.engine.pipeline import profile_arrays
    from slimm_jax.io import AlignmentFile
    from slimm_jax.parallel.multihost import MultiHostRunner

    assert len(jax.devices()) == 2 * n_proc, jax.devices()

    # per-process private copy; seeded generators make the bytes identical
    my_dir = os.path.join(work_dir, f"p{pid}")
    os.makedirs(my_dir, exist_ok=True)
    ds = build_toy_dataset(my_dir)
    db = build_toy_db(ds)

    af = AlignmentFile(ds.sam_path)
    batch = af.load()
    read_id = np.asarray(batch.read_id, np.int64)
    # HOST-LOCAL reads: this process keeps reads with id % n_proc == pid,
    # renumbered densely (grouping preserved — all records of a read stay
    # on one host, exactly the multi-host decode contract)
    mine = (read_id % n_proc) == pid
    local_read = (read_id[mine] // n_proc).astype(np.int32)
    local_rid = batch.rid[mine]
    local_pos = batch.pos[mine]

    runner = MultiHostRunner()
    st = profile_arrays(
        ProfileOptions(), copy.deepcopy(db), af.contig_names,
        af.contig_lengths, local_read, local_rid, local_pos,
        batch.n_reads, batch.hits_count, batch.avg_read_length,
        engine=EngineOptions(phase_log=False), sharded_runner=runner)

    if pid == 0:
        with open(out_tsv, "wt") as f:
            for row in st.abundance_rows():
                f.write("\t".join(row) + "\n")
        print("WROTE", out_tsv, flush=True)

    # ---- streaming x multi-host ----
    # each host streams a per-host SAM holding only ITS reads (complete
    # reads per host, deterministic split by first-appearance order);
    # chunked dispatch over the global mesh must merge to the same rows
    from slimm_jax.io import native

    if native.available():
        from slimm_jax.engine.pipeline import profile_file_streaming
        from tests.toy import write_sam

        order_idx: dict = {}
        for rec in ds.records:
            order_idx.setdefault(rec[0], len(order_idx))
        mine_recs = [r for r in ds.records
                     if order_idx[r[0]] % n_proc == pid]
        my_sam = write_sam(my_dir, mine_recs, name="mine.sam")
        st2 = profile_file_streaming(
            ProfileOptions(), copy.deepcopy(db), my_sam,
            engine=EngineOptions(phase_log=False), chunk_targets=512,
            sharded_runner=MultiHostRunner())
        if pid == 0:
            with open(out_tsv + ".stream", "wt") as f:
                for row in st2.abundance_rows():
                    f.write("\t".join(row) + "\n")
            print("WROTE", out_tsv + ".stream", flush=True)
    else:
        print("NO-NATIVE: streaming leg skipped", flush=True)

    print("DONE", pid, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
