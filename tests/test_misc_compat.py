"""Parity tests for the reference's out-of-flow utility helpers
(misc.hpp:274-338, 368-455, 524-538 — dead in the reference's current
call graph but part of its API surface)."""

import math

import pytest

from slimm_jax.misc_compat import (calculate_alignment_score, get_lca_tree,
                                   get_lca_tree_list, get_taxon_id,
                                   get_taxon_id_pos, mean, median, std_dev,
                                   variance)

# toy nodes.dmp table: {taxid: (parent, rank)}
NODES = {
    1: (1, "no rank"),
    2: (1, "superkingdom"),
    1224: (2, "phylum"),
    1236: (1224, "class"),
    543: (1236, "family"),
    561: (543, "genus"),
    562: (561, "species"),
    620: (543, "genus"),
    622: (620, "species"),
    1239: (2, "phylum"),
    1396: (1239, "species"),
}


def test_stats_float():
    v = [1.0, 2.0, 3.0, 4.0]
    assert mean(v) == 2.5
    m = mean(v)
    assert variance(v, m) == pytest.approx(1.25)
    assert std_dev(v) == pytest.approx(math.sqrt(1.25))


def test_stats_integer_division():
    # C++ integer T: sum/size truncates (misc.hpp:285-289)
    assert mean([1, 2, 3, 4]) == 2          # 10 // 4
    assert variance([1, 2, 3, 5]) == 2      # m=2; (1+0+1+9)//4


def test_median_quirks():
    # EVEN size returns v[n] (upper middle, NO averaging) — the
    # reference's branches are swapped relative to the textbook median
    assert median([1.0, 2.0, 3.0, 4.0]) == 3.0
    # ODD size averages v[n] and v[n+1]
    assert median([1.0, 2.0, 10.0]) == 6.0  # (v[1] + v[2]) / 2
    assert median([5, 1, 3, 7]) == 5        # sorted [1,3,5,7] → v[2]


def test_alignment_score():
    # (edit distance + I/D base counts) / read length (misc.hpp:323-338)
    assert calculate_alignment_score("10M", 2, 10) == pytest.approx(0.2)
    assert calculate_alignment_score("3M2I4M1D", 1, 10) == pytest.approx(0.4)
    assert calculate_alignment_score(
        [("M", 5), ("I", 3)], 0, 8) == pytest.approx(3 / 8)


def test_tree_lca_basic():
    # species under the same genus → genus; across genera → family
    assert get_lca_tree({562, 561}, NODES) == 561
    assert get_lca_tree({562, 622}, NODES) == 543
    # across phyla → superkingdom; with the root in the table this
    # terminates at the common ancestor 2
    assert get_lca_tree({562, 1396}, NODES) == 2
    # singleton short-circuit of the vector overload
    assert get_lca_tree_list([562, 562], NODES) == 562
    assert get_lca_tree_list([562, 622, 1396], NODES) == 2


def test_tree_lca_escapes_table():
    # unknown parent chain → 0 (misc.hpp:404-407)
    nodes = {10: (99, "species"), 11: (98, "species")}
    assert get_lca_tree({10, 11}, nodes) == 0


def test_tree_lca_valid_filter():
    # only members of valid_taxon_ids participate (misc.hpp:370-377)
    assert get_lca_tree({562, 622, 1396}, NODES,
                        valid_taxon_ids={562, 622}) == 543


def test_taxon_id_field_locator():
    # the preprocessing merge writes 'acc|kraken:taxid|<taxid> desc'
    # headers (tools/preprocess.py, reference merge_files.py:55-74)
    assert get_taxon_id("NC_1|kraken:taxid|562", "kraken:taxid") == (True, 2)
    assert get_taxon_id("gi|5|ti|1396|x", "ti") == (True, 3)
    assert get_taxon_id("plain_name", "ti") == (False, 0)
    assert get_taxon_id_pos("a|ti|7") == 2
    assert get_taxon_id_pos("a|kraken:taxid|7") == 2
    with pytest.raises(SystemExit):
        get_taxon_id_pos("no_marker_here")
