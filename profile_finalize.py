"""Host-finalize profile at full-RefSeq cardinality.

Builds a synthetic ProfileState with N_CONTIGS contigs whose lineages span
~N_TAXA distinct taxids, fills taxon_id__read_count / taxon_id__children at
N_LCA LCA taxids (the worst realistic case: every species got reads), then
times the host tail exactly as `_finalize_state` runs it:

  1. dense-counts -> taxid dict loop
  2. pair-presence decode -> children sets loop
  3. propagate_counts (ancestor propagation, slimm.hpp:559-610)
  4. abundance_rows at every rank (report writers walk the dicts)

Usage: python profile_finalize.py [n_contigs] [n_lca]

Measured (2 vCPU host, 2026-08): the pure-Python loop at 50k contigs /
62k distinct LCA taxids took 6.1 s (propagate) + 4.2 s (rows, all ranks);
with the native stpu_propagate_run path + array-backed children sets it is
1.6 s + 0.7 s.  At the 5k-contig / 6k-taxid scale of a curated bacterial
DB: 0.13 s + 0.07 s — a few % of the per-file end-to-end time.
"""
from __future__ import annotations

import sys
import time

import numpy as np

from slimm_jax.config import ProfileOptions
from slimm_jax.state import ProfileState
from slimm_jax.taxonomy import LINEAGE_LENGTH


def build_synthetic(n_contigs: int, n_lca: int, seed: int = 0,
                    shuffle_taxids: bool = False):
    """`shuffle_taxids` remaps taxid values through a random bijection so
    numeric order is uncorrelated with rank level — this exercises the
    sequential order-dependence of propagate_counts (a receiver processed
    BEFORE some of its contributors sees their pushes late)."""
    rng = np.random.default_rng(seed)
    # taxonomy shape: strains -> species -> genus -> ... -> superkingdom,
    # fanout ~5 per level like real RefSeq bacteria
    lineages = np.zeros((n_contigs, LINEAGE_LENGTH), np.int64)
    base = 1_000_000
    lineages[:, 0] = base + np.arange(n_contigs)            # strain/species
    for lvl in range(1, LINEAGE_LENGTH):
        group = np.arange(n_contigs) // (5 ** lvl)
        lineages[:, lvl] = base + n_contigs + 10_000_000 * lvl + group
    if shuffle_taxids:
        uniq = np.unique(lineages)
        perm = rng.permutation(len(uniq))
        remap = dict(zip(uniq.tolist(),
                         (base + perm * 7 + 1).tolist()))
        lineages = np.vectorize(remap.__getitem__)(lineages)
    ac__taxid = {}
    taxid__name = {}
    accs = [f"ACC{i:07d}" for i in range(n_contigs)]
    for i in range(n_contigs):
        ac__taxid[accs[i]] = lineages[i].tolist()
    for lvl in range(LINEAGE_LENGTH):  # rank code == lineage level
        for t in np.unique(lineages[:, lvl]).tolist():
            taxid__name[int(t)] = (lvl, f"taxon{t}")

    opt = ProfileOptions()
    st = ProfileState(options=opt, ac__taxid=ac__taxid,
                      taxid__name=taxid__name)
    st.accessions = accs
    st.taxa_id = lineages[:, 0].copy()
    st.lengths = rng.integers(1_000_000, 5_000_000,
                              n_contigs).astype(np.int64)
    st.nbins = st.lengths // 1000 + 1
    st.bin_offset = np.concatenate([[0], np.cumsum(st.nbins)[:-1]])
    n = n_contigs
    st.reads_count = rng.integers(0, 2000, n).astype(np.int64)
    st.uniq_reads_count = rng.integers(0, 500, n).astype(np.int64)
    st.uniq_reads_count2 = rng.integers(0, 500, n).astype(np.int64)
    st.abundance = np.zeros(n, np.float32)
    st.uniq_abundance = np.zeros(n, np.float32)
    st.hits_count = int(st.reads_count.sum())
    st.matches_count = st.hits_count
    st.uniq_hits_count = int(st.uniq_reads_count.sum())
    st.avg_read_length = 100
    st.valid_ref_ids = set(range(n))

    # LCA outcome: n_lca taxids spread over the species level (the common
    # case) with a tail at higher ranks; children sets of size 1-8
    lca_levels = rng.choice(LINEAGE_LENGTH, n_lca,
                            p=[.55, .2, .1, .06, .04, .03, .01, .01])
    lca_contig = rng.integers(0, n_contigs, n_lca)
    counts = rng.integers(1, 5000, n_lca)
    read_count = {}
    children = {}
    for i in range(n_lca):
        t = int(lineages[lca_contig[i], lca_levels[i]])
        read_count[t] = read_count.get(t, 0) + int(counts[i])
        ch = children.setdefault(t, set())
        ch.add(int(lca_contig[i]))
        for _ in range(int(rng.integers(0, 8))):
            ch.add(int(rng.integers(0, n_contigs)))
    st.taxon_id__read_count = read_count
    st.taxon_id__children = children
    # pre-seed the memoized cutoffs (bin arrays aren't materialized here)
    st._coverage_cut_off = np.float32(1e-9)
    st._uniq_coverage_cut_off = np.float32(1e-9)
    return st


def main():
    n_contigs = int(sys.argv[1]) if len(sys.argv) > 1 else 5000
    n_lca = int(sys.argv[2]) if len(sys.argv) > 2 else 50_000
    st = build_synthetic(n_contigs, n_lca)
    n_distinct = len(st.taxon_id__read_count)
    print(f"contigs={n_contigs} lca_entries={n_lca} "
          f"distinct_lca_taxids={n_distinct}")

    t0 = time.perf_counter()
    st.propagate_counts()
    t1 = time.perf_counter()
    print(f"propagate_counts: {t1 - t0:.3f} s "
          f"({len(st.taxon_id__read_count)} taxids after propagation)")

    st.compute_abundances()
    from slimm_jax.taxonomy import RANK_LIST
    t2 = time.perf_counter()
    total_rows = 0
    for rank in RANK_LIST[1:]:
        st.options.rank = rank
        rows = st.abundance_rows()
        total_rows += len(rows)
    t3 = time.perf_counter()
    print(f"abundance_rows all ranks: {t3 - t2:.3f} s ({total_rows} rows)")


if __name__ == "__main__":
    main()
