"""Device mesh construction.

The profiling workload is data-parallel over READS (every record of a read
stays on one shard, so per-read dedup/uniqueness/LCA are shard-local and the
merged quantities are integer histograms — psum is exact and shard count is
invisible in the results).  The reference has no parallelism at all
(SURVEY.md §2.4); this is the scale-out axis.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def route_shard(read_id, S: int):
    """Shard assignment for each record's read: a multiplicative hash of
    the read id instead of plain `read_id % S`.

    Every shard is padded to the LOADED-MOST shard's row length, so skew
    is paid by everyone: plain mod-S is adversarial to periodic inputs
    (e.g. multi-hit reads recurring every S reads, or .1/.2 pair keys
    landing in lock-step), while the Fibonacci-hash mix spreads any
    periodic structure.  Routing choice never affects results — merges
    are exact integer psums."""
    h = np.asarray(read_id).astype(np.uint64)
    h = (h * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(17)
    return (h % np.uint64(S)).astype(np.int64)


def make_mesh(num_shards: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the `data` axis (reads)."""
    devs = list(devices if devices is not None else jax.devices())
    n = num_shards or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} shards but only {len(devs)} devices")
    return Mesh(np.asarray(devs[:n]), ("data",))


def make_mesh2(data_shards: int, model_shards: int, devices=None) -> Mesh:
    """2-D mesh: `data` over reads x `model` over the global bin axis.

    The model axis shards the coverage-state histograms (the reference's
    per-contig bins vector, slimm.hpp:124 — SURVEY.md §2.4 row 2): each
    model shard owns a contiguous bin range, so per-device bin memory and
    histogram domain shrink by the model degree (full-RefSeq DBs exceed
    one device's memory).
    """
    devs = list(devices if devices is not None else jax.devices())
    n = data_shards * model_shards
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:n]).reshape(data_shards, model_shards),
                ("data", "model"))
