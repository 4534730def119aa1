import numpy as np

from slimm_jax.state import fmt_float, quantile_cut_off, seq_sum_f32


class TestQuantileCutOff:
    """Exact mass-quantile semantics (misc.hpp:197-216)."""

    def test_empty(self):
        assert quantile_cut_off([], 0.95) == 0

    def test_single(self):
        assert quantile_cut_off([3.0], 0.95) == np.float32(3.0)

    def test_walk_from_top(self):
        # v = [1,2,3,4], total=10, q=0.5: sub=0(<0.5 ratio 0) add 4 → i=2;
        # ratio 0.4 < 0.5 → add 3 → i=1; ratio 0.7 ≥ 0.5 → stop; cutoff=v[1]=2
        assert quantile_cut_off([4.0, 2.0, 1.0, 3.0], 0.5) == np.float32(2.0)

    def test_q_zero_returns_max(self):
        # ratio 0 < 0 is false immediately → cutoff = top element
        assert quantile_cut_off([5.0, 1.0, 9.0], 0.0) == np.float32(9.0)

    def test_walks_to_bottom(self):
        # q=1.0 never satisfied until i hits 0 → cutoff = v[0] = min
        assert quantile_cut_off([5.0, 1.0, 9.0], 1.0) == np.float32(1.0)

    def test_all_zero_nan_guard(self):
        # total = 0 → 0/0 = NaN; NaN < q false → loop never runs → max = 0
        assert quantile_cut_off([0.0, 0.0, 0.0], 0.95) == np.float32(0.0)

    def test_integer_values(self):
        assert quantile_cut_off([10, 20, 30, 40], 0.5) == np.float32(20)


class TestFmtFloat:
    """C++ default-ostream float formatting (6 significant digits)."""

    def test_basic(self):
        assert fmt_float(100.0) == "100"
        assert fmt_float(0.05) == "0.05"
        assert fmt_float(33.333333) == "33.3333"
        assert fmt_float(0.0) == "0"
        assert fmt_float(1.0 / 3.0) == "0.333333"

    def test_scientific(self):
        assert fmt_float(1e-5) == "1e-05"
        assert fmt_float(1234567.0) == "1.23457e+06"

    def test_float32_rounding(self):
        # value must round through float32 first
        assert fmt_float(np.float32(0.1)) == "0.1"


def test_seq_sum_f32_matches_sequential():
    vals = [0.1, 0.2, 0.7, 1e-8, 3.3]
    acc = np.float32(0.0)
    for v in vals:
        acc = np.float32(acc + np.float32(v))
    assert seq_sum_f32(vals) == acc


class TestNativePropagate:
    """Native C++ propagate_counts (stpu_propagate_run) == the pure
    Python loop, bit-for-bit, on synthetic states at above-threshold
    cardinality — including shuffled taxid magnitudes (receivers processed
    before some contributors), rank-8 (INTERMEDIATE) taxids, and taxids
    missing from taxid__name (insert-on-miss default rank)."""

    @staticmethod
    def _pair(n_contigs, n_lca, seed, shuffle):
        import copy

        import profile_finalize as pf
        from slimm_jax.io import native

        if not native.available():
            import pytest
            pytest.skip("native library not built")
        st = pf.build_synthetic(n_contigs, n_lca, seed=seed,
                                shuffle_taxids=shuffle)
        # quirk coverage: an INTERMEDIATE-rank taxid and a nameless taxid
        keys = sorted(st.taxon_id__read_count)
        if len(keys) >= 4:
            st.taxid__name[keys[1]] = (8, "odd_intermediate")
            st.taxid__name.pop(keys[2], None)
        return st, copy.deepcopy(st)

    def _check(self, n_contigs, n_lca, seed, shuffle):
        st_pure, st_nat = self._pair(n_contigs, n_lca, seed, shuffle)
        st_pure.NATIVE_PROPAGATE_MIN = 10**9   # force the Python loop
        st_pure.propagate_counts()
        assert st_nat._propagate_native()
        assert st_nat.taxon_id__read_count == st_pure.taxon_id__read_count
        assert set(st_nat.taxon_id__children) == set(
            st_pure.taxon_id__children)
        for t, ch in st_nat.taxon_id__children.items():
            got = set(ch.tolist()) if isinstance(ch, np.ndarray) else set(ch)
            assert got == st_pure.taxon_id__children[t], t
        # name_of side effects replicated (insert-on-miss during rank read)
        assert st_nat.taxid__name == st_pure.taxid__name
        # downstream report rows agree through the array-backed children
        for st in (st_pure, st_nat):
            st.compute_abundances()
            st._coverage_cut_off = np.float32(1e-9)
            st._uniq_coverage_cut_off = np.float32(1e-9)
        for rank in ("species", "genus", "phylum"):
            st_pure.options.rank = rank
            st_nat.options.rank = rank
            assert st_nat.abundance_rows() == st_pure.abundance_rows()

    def test_parity_ordered(self):
        self._check(400, 6000, seed=1, shuffle=False)

    def test_parity_shuffled_taxids(self):
        self._check(400, 6000, seed=2, shuffle=True)

    def test_parity_shuffled_large(self):
        self._check(1500, 20000, seed=3, shuffle=True)
