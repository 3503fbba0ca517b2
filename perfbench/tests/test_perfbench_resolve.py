"""The harness finds every part of a cell by its name, from files alone."""
import dataclasses
import json

import pytest

from conftest import BENCH, REPO
from perfbench import generator, harness


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_from_files(name):
    cell = harness.resolve(name, BENCH)
    w = next(w for w in BENCH["workloads"] if w["name"] == name)
    conf = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert cell.config == json.loads((REPO / conf["file"]).read_text())
    assert cell.mix == json.loads(
        (REPO / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())
    assert cell.chips == w["chips"]
    assert {m["name"] for m in cell.end_to_end} >= {"tokens_per_s",
                                                    "setup_s"}
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert callable(harness.reader(m["name"]))
    ref = harness.reference(cell.config["reference"])
    assert ref.param_specs(cell.config["model"])


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_ports_config(conf):
    """The sizes the cell runs are the port's published configuration."""
    from repro_torch.configs import get_config
    config = json.loads((REPO / conf["file"]).read_text())
    assert config["name"] == conf["name"]
    assert config["source"] == conf["source"]
    assert config["reduced"] == conf["reduced"] == []
    ours = harness.arch_config(config["model"])
    port = get_config(config["port_config"])
    assert dataclasses.replace(ours, source="") == \
        dataclasses.replace(port, source="")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert (REPO / "perfbench" / "metrics" / f"{m['name']}.py").exists()
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
        generator.check_mix(json.loads((REPO / "perfbench" / "traffic"
                                        / f"{w['traffic']}.json").read_text()))
