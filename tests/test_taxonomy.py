from slimm_jax.taxonomy import (
    LINEAGE_LENGTH,
    Rank,
    accession_id,
    considered_ranks,
    rank_name,
    rank_short,
    to_rank,
)


def test_rank_values_match_reference_enum():
    # misc.hpp:24-35
    assert Rank.STRAIN == 0
    assert Rank.SPECIES == 1
    assert Rank.SUPERKINGDOM == 7
    assert Rank.INTERMEDIATE == 8
    assert LINEAGE_LENGTH == 8


def test_rank_round_trip():
    for name in ["strain", "species", "genus", "family", "order", "class",
                 "phylum", "superkingdom"]:
        assert rank_name(to_rank(name)) == name
    assert to_rank("no rank") == Rank.INTERMEDIATE
    assert to_rank("subspecies") == Rank.INTERMEDIATE
    # reference spelling quirk (misc.hpp:61)
    assert rank_name(Rank.INTERMEDIATE) == "intermidiate"


def test_rank_short():
    assert rank_short(Rank.SPECIES) == "s"
    assert rank_short(Rank.SUPERKINGDOM) == "k"
    assert rank_short(Rank.STRAIN) == "r"
    assert rank_short(Rank.INTERMEDIATE) == "i"


def test_accession_id():
    # first chunk split on whitespace/'.'/'|' (misc.hpp:415-422)
    assert accession_id("NC_000913.3 Escherichia coli") == "NC_000913"
    assert accession_id("NC_000913.3") == "NC_000913"
    assert accession_id("acc|kraken:taxid|562 desc") == "acc"
    assert accession_id("plain") == "plain"
    assert accession_id("a\tb") == "a"
    assert accession_id(".leading") == "leading"  # empty chunks dropped


def test_considered_ranks():
    # slimm.hpp:498-514
    assert considered_ranks("species") == [2, 1]          # [genus, species]
    assert considered_ranks("genus") == [3, 2]
    assert considered_ranks("all") == [7, 6, 5, 4, 3, 2, 1, 0]
    assert considered_ranks("superkingdom") == [7, 7]     # sane OOB fix
    assert considered_ranks("strains") == [9, 8]          # rankList quirk
