"""Exactness of the engine's device primitives against numpy: the coverage
histograms (_hist2/_hist1, XLA scatter-add) and the per-contig table
gathers (pass-A binning, _lineage_rows, _table_col).  Every output is an
integer, so every comparison is exact."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slimm_jax.engine.pipeline import (_hist1, _hist2, _lineage_rows,
                                       _pass_a_local, _table_col)


def _bincount(idx, w, n_bins):
    idx = np.asarray(idx)
    w = np.asarray(w)
    return np.bincount(idx[w], minlength=n_bins)[:n_bins]


@pytest.mark.parametrize("seed,density", [(0, 0.9), (1, 0.0), (2, 1.0)])
def test_hist2_matches_bincount(seed, density):
    rng = np.random.default_rng(seed)
    n, bp = 8192, 2048
    idx = rng.integers(0, bp, n).astype(np.int32)
    w1 = rng.random(n) < density
    w2 = rng.random(n) < 0.5
    h1, h2 = jax.jit(_hist2, static_argnums=3)(
        jnp.asarray(idx), jnp.asarray(w1), jnp.asarray(w2), bp)
    np.testing.assert_array_equal(np.asarray(h1), _bincount(idx, w1, bp))
    np.testing.assert_array_equal(np.asarray(h2), _bincount(idx, w2, bp))


@pytest.mark.parametrize("case", ["random", "heavy_bin"])
def test_hist1_matches_bincount(case):
    rng = np.random.default_rng(3)
    n, bp = 4096, 1024
    if case == "random":
        idx = rng.integers(0, bp, n).astype(np.int32)
        w = rng.random(n) < 0.7
    else:  # one bin takes every hit
        idx = np.zeros(n, np.int32)
        w = np.ones(n, bool)
    h = np.asarray(jax.jit(_hist1, static_argnums=2)(
        jnp.asarray(idx), jnp.asarray(w), bp))
    np.testing.assert_array_equal(h, _bincount(idx, w, bp))
    if case == "heavy_bin":
        assert int(h[0]) == n and int(h[1:].sum()) == 0


def test_hist2_packed_scatter_overflow_fallback():
    # engine _hist2: both counts ride one uint32 scatter (lo/hi 16-bit
    # fields).  A bin reaching 2^16 w1-hits overflows the low field; the
    # total-mass guard must detect it and the lax.cond fall back to the
    # exact two-scatter branch.
    bp = 1024
    # 70_000 > 2^16 records all in bin 3 (plus a scattered tail)
    rng = np.random.default_rng(4)
    n = 80_000
    idx = np.full(n, 3, np.int32)
    idx[70_000:] = rng.integers(0, bp, n - 70_000)
    w1 = np.ones(n, bool)
    w2 = rng.random(n) < 0.4
    h1, h2 = _hist2(jnp.asarray(idx), jnp.asarray(w1), jnp.asarray(w2), bp)
    np.testing.assert_array_equal(np.asarray(h1), _bincount(idx, w1, bp))
    np.testing.assert_array_equal(np.asarray(h2), _bincount(idx, w2, bp))
    assert int(h1[3]) == 70_000 + int((idx[70_000:] == 3).sum())
    # and the packed fast path itself (no overflow) stays exact
    idx_s = rng.integers(0, bp, n).astype(np.int32)
    h1, h2 = _hist2(jnp.asarray(idx_s), jnp.asarray(w1), jnp.asarray(w2), bp)
    np.testing.assert_array_equal(np.asarray(h1), _bincount(idx_s, w1, bp))
    np.testing.assert_array_equal(np.asarray(h2), _bincount(idx_s, w2, bp))


def test_pass_a_matmul_gather_chromosome_scale():
    # pass A's per-contig table gathers must bin chromosome-scale contigs
    # exactly (lengths and bin offsets > 2^24, where a float32 path would
    # lose bits).  Compared against a numpy recompute of
    # center/bin/global-bin.
    rng = np.random.default_rng(5)
    n_contigs = 5
    lengths = np.array([700_000_000, 650_000_001, 700_000_000,
                        700_000_000, 120_000_000], np.uint32)
    bw = np.int32(150)
    nbins = lengths // np.uint32(bw) + 1
    boff = np.concatenate([[0], np.cumsum(nbins)[:-1]]).astype(np.int32)
    assert int(lengths.max()) > (1 << 24) and int(boff.max()) > (1 << 24)
    n = 4096
    read_id = np.arange(n, dtype=np.int32)
    rid = rng.integers(0, n_contigs, n).astype(np.int32)
    pos = (rng.random(n) * (lengths[rid] - 150)).astype(np.int64).astype(
        np.int32)
    half = np.int32(75)
    total_bins_pad = -(-int(nbins.sum()) // 1024) * 1024
    out = jax.jit(lambda a, b, c: _pass_a_local(
        a, b, c, jnp.asarray(lengths), jnp.asarray(boff), half, bw,
        n_contigs=n_contigs, total_bins_pad=total_bins_pad,
        dedup_window=0, k_steps=1, window=1))(read_id, rid, pos)
    center = np.minimum(pos.astype(np.uint32) + 75, lengths[rid])
    expect = boff[rid] + (center // np.uint32(150)).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(out["t_gbin"]), expect)
    cov = np.asarray(out["cov"])
    assert int(cov.sum()) == n
    np.testing.assert_array_equal(
        cov, np.bincount(expect, minlength=total_bins_pad))


# table values straddling the largest integers that TF32 (2^11), a 16-bit
# half (2^16) and float32 (2^24) hold exactly
SCALES = [1 << 11, 1 << 16, 1 << 24]


def _table_and_index(scale, n_contigs=1000, n=20_000, width=None):
    rng = np.random.default_rng(scale % 997)
    shape = (n_contigs,) if width is None else (n_contigs, width)
    table = (scale - 500 + rng.integers(0, 1000, shape)).astype(np.int32)
    ridx = rng.integers(-1, n_contigs + 1, n).astype(np.int32)  # incl. OOR
    return table, ridx, np.clip(ridx, 0, n_contigs - 1)


@pytest.mark.parametrize("scale", SCALES)
def test_lineage_rows_exact(scale):
    lineage, ridx, rc = _table_and_index(scale, width=8)
    got = jax.jit(_lineage_rows, static_argnums=2)(
        jnp.asarray(lineage), jnp.asarray(ridx), lineage.shape[0])
    np.testing.assert_array_equal(np.asarray(got), lineage[rc])


@pytest.mark.parametrize("scale", SCALES)
def test_table_col_exact(scale):
    col, ridx, rc = _table_and_index(scale)
    got = jax.jit(_table_col, static_argnums=2)(
        jnp.asarray(col), jnp.asarray(ridx), col.shape[0])
    np.testing.assert_array_equal(np.asarray(got), col[rc])


@pytest.mark.parametrize("scale", SCALES)
def test_pass_a_binning_exact(scale):
    # contig lengths and bin offsets around `scale`, bin width 1 so local
    # bins are as large as the lengths themselves
    rng = np.random.default_rng(scale % 991)
    n_contigs, n = 1000, 20_000
    lengths = (scale - 500 + rng.integers(0, 1000, n_contigs)).astype(
        np.uint32)
    boff = (scale + np.arange(n_contigs) * 7).astype(np.int32)
    rid = rng.integers(0, n_contigs, n).astype(np.int32)
    pos = (rng.random(n) * lengths[rid]).astype(np.int64).astype(np.int32)
    read_id = np.arange(n, dtype=np.int32)
    out = jax.jit(lambda a, b, c: _pass_a_local(
        a, b, c, jnp.asarray(lengths), jnp.asarray(boff), np.int32(75),
        np.int32(1), n_contigs=n_contigs, total_bins_pad=1024,
        dedup_window=0, k_steps=1, window=1))(read_id, rid, pos)
    center = np.minimum(pos.astype(np.uint32) + 75, lengths[rid])
    np.testing.assert_array_equal(np.asarray(out["t_gbin"]),
                                  boff[rid] + center.astype(np.int32))
