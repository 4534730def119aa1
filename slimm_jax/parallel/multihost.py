"""Multi-host execution: jax.distributed runtime + host-sharded decode.

The reference is one process on one core (SURVEY.md §2.4); across hosts
the layout is:

  * every HOST decodes its own slice of the input (whole files in
    directory mode, or record ranges split at read boundaries for one
    huge file) with the native C++ decoder — alignment decode is
    embarrassingly parallel across hosts;
  * read ids are HOST-LOCAL (each host's records are complete reads), so
    per-read dedup/uniqueness/LCA stay shard-local exactly as in the
    single-host ShardedRunner;
  * the fused profile runs under ONE global mesh spanning every host's
    devices; the integer histogram/count psums run over the devices'
    interconnect within a host and the network across hosts.  Integer
    collectives are exact, so N hosts produce bit-identical profiles to
    one host (the same invariance the tests establish on the virtual CPU
    mesh).

Launch (one command per host):

    python -m slimm_jax.parallel.multihost --coordinator host0:9876 \
        --num-processes 4 --process-id $SLURM_PROCID -- \
        profile DB.sldb reads_dir -d -o out/

or programmatically via `initialize()` + `MultiHostRunner`.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..engine.pipeline import _bucket, _fused_core


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """jax.distributed.initialize wrapper (no-op for single-process runs).
    Pass all three arguments where the cluster environment does not
    provide them."""
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def shard_paths(paths: list, process_index: int | None = None,
                process_count: int | None = None) -> list:
    """Directory mode: round-robin file assignment across hosts."""
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    return [p for i, p in enumerate(paths) if i % pc == pi]


class MultiHostRunner:
    """`sharded_runner` for engine.profile_arrays spanning every host.

    Each process feeds records for ITS reads only; read ids must be
    host-local (the decoder's per-host dictionary already is).  All
    merged outputs (packed stats, histograms) are fully replicated, so
    every host can write reports (or only process 0, caller's choice).
    """

    def __init__(self, mesh: Mesh | None = None):
        if mesh is None:
            devs = np.asarray(jax.devices())     # all hosts' devices
            mesh = Mesh(devs, ("data",))
        self.mesh = mesh
        self.local_shards = len([d for d in mesh.devices.flat
                                 if d.process_index == jax.process_index()])
        self.n_shards = mesh.devices.size
        self._jit_cache: dict = {}

    def sync_max_run(self, max_run: int) -> int:
        """Agree on the global longest equal-read run: the segment-reduction
        plan derived from it is a static jit argument, and every process
        must compile the same SPMD program."""
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils
            all_mr = multihost_utils.process_allgather(
                np.asarray([max_run], np.int64))
            return int(np.max(all_mr))
        return max_run

    def _shard_counts(self, read_id):
        """Per-local-shard record counts under the hashed routing (actual
        counts can exceed an even split when multi-hit reads cluster)."""
        from .mesh import route_shard

        S = self.local_shards
        valid = np.asarray(read_id) >= 0
        shard = route_shard(np.asarray(read_id)[valid], S)
        return np.bincount(shard, minlength=S)

    def _route_local(self, read_id, rid, pos, n_s):
        """Partition THIS host's records over its local shards by read."""
        from .mesh import route_shard

        S = self.local_shards
        valid = read_id >= 0
        shard = np.where(valid, route_shard(read_id, S), -1)
        local_read = np.where(valid, read_id, -1).astype(np.int32)
        order = np.argsort(shard, kind="stable")
        shard_sorted = shard[order]
        counts = np.bincount(shard_sorted[shard_sorted >= 0], minlength=S)
        out_read = np.full((S, n_s), -1, np.int32)
        out_rid = np.zeros((S, n_s), np.int32)
        out_pos = np.zeros((S, n_s), np.int32)
        start = int((shard_sorted < 0).sum())
        for s in range(S):
            c = int(counts[s])
            sel = order[start:start + c]
            out_read[s, :c] = local_read[sel]
            out_rid[s, :c] = rid[sel]
            out_pos[s, :c] = pos[sel]
            start += c
        return out_read, out_rid, out_pos

    def _get_fused(self, n_s, **kw):
        key = (n_s, tuple(sorted(kw.items())))
        fn = self._jit_cache.get(key)
        if fn is not None:
            return fn
        mesh = self.mesh
        emit = kw.get("emit_coverage", True)

        def shard_fn(read_id, rid, pos, lengths_u32, bin_offset, bin_ends,
                     half, bin_width, lineage, sk_code, q):
            out = _fused_core(read_id[0], rid[0], pos[0], lengths_u32,
                              bin_offset, bin_ends, half, bin_width,
                              lineage, sk_code, q, psum_axis="data",
                              **kw)
            # the bitpacked (contig x code) pair presence rides in the
            # replicated packed tail — every output is replicated, so any
            # host can fetch it (no allgather of record-sized arrays).
            # emit_coverage=False: no bin-domain histograms at all (matches
            # the single-device -ro/-co-off path)
            if emit:
                return (out["packed"], out["cov"], out["uniq_cov"],
                        out["uniq_cov2"])
            return (out["packed"],)

        mapped = jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P("data", None),) * 3 + (P(),) * 8,
            out_specs=(P(),) * (4 if emit else 1))
        fn = jax.jit(mapped)
        self._jit_cache[key] = fn
        return fn

    def fused(self, read_id, rid, pos, lengths_u32, bin_offset, bin_ends,
              half, bin_width, lineage, sk_code, q, **kw):
        # agree on the shard row length across hosts: max ACTUAL per-shard
        # count (shard = hash(read id), so loads can be uneven), allgathered
        per_shard = int(max(self._shard_counts(read_id).max(), 1))
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils
            all_n = multihost_utils.process_allgather(
                np.asarray([per_shard], np.int64))
            per_shard = int(np.max(all_n))
        n_s = _bucket(per_shard, 2048)

        read2d, rid2d, pos2d = self._route_local(
            np.asarray(read_id), np.asarray(rid), np.asarray(pos), n_s)
        from jax.sharding import NamedSharding
        sh = NamedSharding(self.mesh, P("data", None))
        if jax.process_count() > 1:
            mk = jax.make_array_from_process_local_data
            read_g = mk(sh, read2d)
            rid_g = mk(sh, rid2d)
            pos_g = mk(sh, pos2d)
        else:
            read_g, rid_g, pos_g = read2d, rid2d, pos2d

        fn = self._get_fused(n_s, **kw)
        outs = fn(read_g, rid_g, pos_g, jnp.asarray(lengths_u32),
                  jnp.asarray(bin_offset), jnp.asarray(bin_ends),
                  jnp.asarray(half), jnp.asarray(bin_width),
                  jnp.asarray(lineage), jnp.asarray(sk_code),
                  jnp.asarray(q))
        out = dict(packed=outs[0])
        if kw.get("emit_coverage", True):
            out.update(cov=outs[1], uniq_cov=outs[2], uniq_cov2=outs[3])
        return out


def main(argv=None):
    """Per-host CLI launcher: initialize the distributed runtime, then run
    the normal `slimm_jax` CLI with the input sharded across hosts."""
    import argparse
    import sys

    p = argparse.ArgumentParser(prog="slimm_jax.parallel.multihost")
    p.add_argument("--coordinator", default=None,
                   help="coordinator_address host:port (auto-detected "
                        "only where the cluster environment provides it)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("rest", nargs=argparse.REMAINDER,
                   help="-- followed by the normal slimm_jax CLI arguments")
    args = p.parse_args(argv)

    initialize(args.coordinator, args.num_processes, args.process_id)
    rest = args.rest[1:] if args.rest[:1] == ["--"] else args.rest
    from ..cli import main as cli_main
    sys.exit(cli_main(rest))


if __name__ == "__main__":
    main()
