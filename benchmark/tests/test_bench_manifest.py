"""BENCHMARK.json against the benchmark's contract, and every file it names:
the rules of ``manifest_rules``, each on the repo's manifest."""

import pytest
from conftest import ROOT

import manifest
import manifest_rules as rules

M = manifest.load_manifest()
CELLS = [w["name"] for w in M["workloads"]]


def test_top_level_and_sizes():
    rules.top_level_and_sizes(M, ROOT)


def test_entries_have_just_their_keys():
    rules.entries_have_just_their_keys(M, ROOT)


def test_names_are_unique_and_plain():
    rules.names_are_unique_and_plain(M, ROOT)


def test_files_are_named_from_names():
    rules.files_are_named_from_names(M, ROOT)


def test_metrics_move_end_to_end_ones():
    rules.metrics_move_end_to_end_ones(M, ROOT)


def test_inverse_roofline_only_where_blocks_are_inverted():
    rules.inverse_roofline_only_where_blocks_are_inverted(M, ROOT)


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_and_cross_refers(name):
    rules.cell_loads_and_cross_refers(M, ROOT, name)
