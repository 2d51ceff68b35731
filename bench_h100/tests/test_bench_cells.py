"""The harness finds every configuration, traffic mix and metric reader
that BENCHMARK.json names, by name."""

import os

import pytest

from harness import cells

BENCH = cells.load_benchmark()


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_pieces_found(name):
    cell = cells.find_cell(name, BENCH)
    assert cell.config["name"] == cell.config_name
    assert set(cell.traffic) == {"freqs_per_request", "host_threads", "why"}
    assert {m["name"] for m in cell.end_to_end} >= {"solve_s", "setup_s"}
    moved = {m["name"] for m in cell.end_to_end}
    assert cell.per_layer and all(m["moves"] in moved for m in cell.per_layer)


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["end_to_end"]
                                  + BENCH["per_layer"]])
def test_metric_reader_found(name):
    assert callable(cells.metric_reader(name))


def test_config_files_under_paths():
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert os.path.exists(os.path.join(cells.REPO_DIR, c["file"]))


def test_unknown_cell_refused():
    with pytest.raises(KeyError):
        cells.find_cell("no-such.cell", BENCH)


def test_frequency_stream_strata():
    from harness.traffic import STRATA, FrequencyStream

    cell = cells.find_cell("cavity-p3.sweep", BENCH)
    f0, f1 = cell.config["band_ghz"]
    a = FrequencyStream(2 ** 31 + 7, (f0, f1), cell.traffic)
    b = FrequencyStream(2 ** 31 + 7, (f0, f1), cell.traffic)
    r = a.next_request()
    assert r == b.next_request()
    width = (f1 - f0) / STRATA
    assert sorted(int((f - f0) // width) for f in r) == list(range(STRATA))
    assert FrequencyStream(-3, (f0, f1), cell.traffic).next_request() != r
