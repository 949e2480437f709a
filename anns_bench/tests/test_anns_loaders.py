"""Routes, entries, data generators and wire clients are files found by the
name a traffic mix or a configuration gives: every name the cells use
loads, and an unknown name fails with that name in its message."""

import re

import numpy as np
import pytest
import torch

from anns_bench import data, tracing
from anns_bench.cell import load, load_cell
from anns_bench.traffic import Traffic

CELLS = ("sift1m-ivfpq-triage.search-b64", "sift1m-bfv-packed.rerank-b64")


def test_every_name_the_cells_use_loads():
    for name in CELLS:
        cell = load_cell(name)
        route = load("routes", cell.traffic["route"])
        assert issubclass(route.Route, Traffic)
        assert callable(route.judge) and callable(route.control)
        assert callable(route.answered)
        assert callable(load("entries", cell.traffic["entry"]).Entry)
        gen = load("generators", cell.config["dataset"]["generator"])
        assert callable(gen.generate)
    he = load_cell(CELLS[1]).config["he"]
    assert callable(load("client", f"{he['scheme']}_{he['resp_mod']}").Client)


def test_a_name_is_spelt_into_a_file_name():
    assert load("routes", "coarse+encrypted").__name__ == \
        "anns_bench.routes.coarse_encrypted"


@pytest.mark.parametrize("kind", ["routes", "entries", "generators", "client"])
def test_an_unknown_name_fails_with_the_name(kind):
    with pytest.raises(ValueError, match=re.escape("'no-such+thing'")):
        load(kind, "no-such+thing")


@pytest.mark.parametrize("key", ["route", "entry"])
def test_a_mix_with_an_unknown_route_or_entry_fails(key):
    cell = load_cell(CELLS[0])
    mix = dict(cell.traffic, **{key: "teleport"})
    with pytest.raises(ValueError, match="'teleport'"):
        Traffic(mix, cell.config, None, np.zeros((4, 128), np.float32), 1,
                tracing.Tracer(False))


def test_a_configuration_with_an_unknown_generator_fails():
    spec = dict(load_cell(CELLS[0]).config["dataset"], generator="lottery")
    with pytest.raises(ValueError, match="'lottery'"):
        data.generate(spec, 1, torch.device("cpu"))
