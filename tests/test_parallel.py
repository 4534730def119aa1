"""Shard-count invariance: N-shard runs are bit-equal to the 1-shard run
(integer histograms merge exactly via psum), and both equal the oracle."""

import copy

import numpy as np
import pytest

import jax

from slimm_jax.config import EngineOptions, ProfileOptions
from slimm_jax.engine import profile_file
from slimm_jax.parallel import ShardedRunner, make_mesh

from tests.test_engine import assert_states_equal, run_both
from tests.toy import build_toy_db, build_toy_dataset


def run_sharded(toy_dir, num_shards):
    db = copy.deepcopy(build_toy_db(toy_dir))
    runner = ShardedRunner(num_shards=num_shards)
    return profile_file(ProfileOptions(), db, toy_dir.sam_path,
                        engine=EngineOptions(phase_log=False),
                        sharded_runner=runner)


@pytest.mark.parametrize("num_shards", [1, 2, 4, 8])
def test_sharded_matches_oracle(toy_dir, num_shards):
    st_o, _ = run_both(toy_dir)
    st_s = run_sharded(toy_dir, num_shards)
    assert_states_equal(st_o, st_s)


def test_sharded_large_random(tmp_path):
    ds = build_toy_dataset(str(tmp_path), n_extra=3000, seed=77)
    st_o, _ = run_both(ds)
    db = copy.deepcopy(build_toy_db(ds))
    st_s = profile_file(ProfileOptions(), db, ds.sam_path,
                        engine=EngineOptions(phase_log=False),
                        sharded_runner=ShardedRunner(num_shards=8))
    assert_states_equal(st_o, st_s)


def test_route_shard_balances_periodic_skew():
    # adversarial input: multi-hit reads recur every S reads — plain
    # read_id % S would put every extra record on one shard; the hashed
    # routing keeps the padded row length near the even split
    from slimm_jax.parallel.mesh import route_shard

    S = 8
    n_reads = 80_000
    read_id = np.repeat(np.arange(n_reads), 1)
    heavy = read_id[read_id % S == 3]          # periodic heavy reads
    read_id = np.sort(np.concatenate([read_id] + [heavy] * 4))
    mod_counts = np.bincount(read_id % S, minlength=S)
    hash_counts = np.bincount(route_shard(read_id, S), minlength=S)
    even = len(read_id) / S
    assert mod_counts.max() > 1.5 * even       # mod-S really is skewed
    assert hash_counts.max() < 1.15 * even     # hashing spreads it


def test_mesh_construction():
    mesh = make_mesh()
    assert mesh.devices.size == len(jax.devices())
    mesh2 = make_mesh(2)
    assert mesh2.devices.size == 2
    with pytest.raises(ValueError):
        make_mesh(10**6)


def test_multihost_runner_single_process(toy_dir):
    # MultiHostRunner degenerates to the sharded runner in one process;
    # results must equal the plain single-device engine bit-for-bit
    import copy

    from slimm_jax.config import EngineOptions, ProfileOptions
    from slimm_jax.parallel.multihost import MultiHostRunner, shard_paths
    from tests.toy import build_toy_db

    db = build_toy_db(toy_dir)
    eng = EngineOptions(phase_log=False)
    st_single = profile_file(ProfileOptions(), copy.deepcopy(db),
                             toy_dir.sam_path, engine=eng)
    st_multi = profile_file(ProfileOptions(), copy.deepcopy(db),
                            toy_dir.sam_path, engine=eng,
                            sharded_runner=MultiHostRunner())
    from tests.test_engine import assert_states_equal
    assert_states_equal(st_single, st_multi)
    assert shard_paths(["a", "b", "c"], 0, 2) == ["a", "c"]
    assert shard_paths(["a", "b", "c"], 1, 2) == ["b"]


@pytest.mark.parametrize("data,model", [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_model_sharded_matches_oracle(toy_dir, data, model):
    # bin-axis ("model") sharding (SURVEY.md §2.4 row 2): every (data,
    # model) factorization of 8 devices is bit-equal to the oracle —
    # coverage histograms live as per-shard bin slices, per-contig
    # counters merge with an exact psum over the model axis
    st_o, _ = run_both(toy_dir)
    db = copy.deepcopy(build_toy_db(toy_dir))
    runner = ShardedRunner(num_shards=data, model_shards=model)
    st_s = profile_file(ProfileOptions(), db, toy_dir.sam_path,
                        engine=EngineOptions(phase_log=False),
                        sharded_runner=runner)
    assert_states_equal(st_o, st_s)


@pytest.mark.parametrize("make_runner", [
    lambda: ShardedRunner(num_shards=4),
    lambda: ShardedRunner(num_shards=2, model_shards=2),
    lambda: __import__("slimm_jax.parallel.multihost",
                       fromlist=["MultiHostRunner"]).MultiHostRunner(),
], ids=["data4", "data2xmodel2", "multihost"])
def test_sharded_no_coverage_fetch(toy_dir, make_runner):
    # fetch_coverage=False must flow through the scale-out runners too:
    # the shard_fn returns ONLY the packed stats (no bin-domain
    # histograms computed or materialized), and every integer counter and
    # report row is identical to the fetch_coverage=True run
    st_full = run_sharded(toy_dir, 4)
    db = copy.deepcopy(build_toy_db(toy_dir))
    runner = make_runner()
    st_nc = profile_file(ProfileOptions(), db, toy_dir.sam_path,
                         engine=EngineOptions(phase_log=False,
                                              fetch_coverage=False),
                         sharded_runner=runner)
    for name in ("hits_count", "matches_count", "uniq_matches_count",
                 "uniq_matches_count2", "reference_count"):
        assert getattr(st_full, name) == getattr(st_nc, name), name
    np.testing.assert_array_equal(st_full.reads_count, st_nc.reads_count)
    np.testing.assert_array_equal(st_full.uniq_reads_count2,
                                  st_nc.uniq_reads_count2)
    assert st_full.valid_ref_ids == st_nc.valid_ref_ids
    assert st_full.taxon_id__read_count == st_nc.taxon_id__read_count
    assert st_full.taxon_id__children == st_nc.taxon_id__children
    assert st_full.abundance_rows() == st_nc.abundance_rows()
    assert st_nc.cov is None and st_nc.uniq_cov2 is None  # not fetched
    # the runner really compiled the no-histogram variant (cache keys
    # embed the kwargs; output arity follows emit_coverage)
    kw_keys = list(runner._jit_cache)
    assert kw_keys, "runner was not used"
    for k in kw_keys:
        assert dict(k[-1]).get("emit_coverage", True) is False


def test_model_sharded_per_device_memory_drops():
    # the per-shard histogram slice is total_bins_pad / model_shards: the
    # whole point of the model axis is that bin-state memory shrinks with
    # the model degree (replicated histograms are what the reference's
    # `references` vector would cost per device)
    from slimm_jax.engine.pipeline import _pass_a_local
    import jax.numpy as jnp

    total_bins_pad = 8 * 1024
    kw = dict(n_contigs=4, total_bins_pad=total_bins_pad, dedup_window=0,
              k_steps=2, window=1)
    read_id = jnp.arange(16, dtype=jnp.int32)
    rid = jnp.zeros(16, jnp.int32)
    pos = jnp.zeros(16, jnp.int32)
    lengths = jnp.full(4, 100, jnp.uint32)
    offs = jnp.asarray([0, 2048, 4096, 6144], jnp.int32)

    full = jax.eval_shape(
        lambda: _pass_a_local(read_id, rid, pos, lengths, offs,
                              jnp.int32(1), jnp.int32(1), **kw))
    sliced = jax.eval_shape(
        lambda: _pass_a_local(read_id, rid, pos, lengths, offs,
                              jnp.int32(1), jnp.int32(1),
                              bin_lo=jnp.int32(1024), hist_bins=1024, **kw))
    assert full["cov"].shape == (total_bins_pad,)
    assert sliced["cov"].shape == (1024,)  # 1/8th per model shard
