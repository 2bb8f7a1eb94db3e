"""BENCHMARK.json against the contract's form, and the harness driven by
data: a configuration, a traffic mix, a cell and a metric added as new
files are found by name."""
import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = harness.load_manifest(ROOT)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_names_and_units():
    m = MANIFEST
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in m[key]]
    names += [w[k] for w in m["workloads"] for k in ("config", "traffic")]
    names += [k for c in m["configs"] for k in c["reduced"]]
    assert all(NAME.fullmatch(n) for n in names), names
    for key in ("configs", "workloads"):
        assert len({x["name"] for x in m[key]}) == len(m[key])
    metrics = m["end_to_end"] + m["per_layer"]
    assert len({x["name"] for x in metrics}) == len(metrics)
    assert all(UNIT.fullmatch(x["unit"]) and x["better"] in ("lower", "higher")
               for x in metrics)
    assert all(0.01 <= x["bound"] <= 0.25 for x in m["end_to_end"])
    assert all(w["chips"] in (1, 4) for w in m["workloads"])


def test_every_piece_has_its_file():
    for c in MANIFEST["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
    for w in MANIFEST["workloads"]:
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_its_metrics_move(cell):
    c = harness.resolve_cell(ROOT, MANIFEST, cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    assert all(m["moves"] in e2e for m in c.per_layer)
    for m in MANIFEST["per_layer"]:
        assert all(w in CELLS for w in m.get("workloads", []))


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix and a metric dropped in as new files,
    and a cell naming them in the manifest, need no edit of the harness."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "portbench"
    config = json.loads((pb / "configs" / "resnet18.json").read_text())
    config["stages"] = [[64, 3], [128, 4], [256, 6], [512, 3]]
    (pb / "configs" / "resnet34.json").write_text(json.dumps(config))
    traffic = json.loads((pb / "traffic" / "offline.r3.b64.json").read_text())
    traffic["batch"] = 8
    (pb / "traffic" / "offline.r3.b8.json").write_text(json.dumps(traffic))
    (pb / "metrics" / "frames_per_batch.py").write_text(
        "def read(ctx):\n    return ctx.frames_per_request\n")
    m = json.loads(json.dumps(MANIFEST))
    m["configs"].append({"name": "resnet34", "source": "https://arxiv.org/abs/1512.03385",
                         "file": "portbench/configs/resnet34.json", "reduced": [],
                         "why": "deeper"})
    m["workloads"].append({"name": "resnet34.offline.r3.b8", "config": "resnet34",
                           "traffic": "offline.r3.b8", "chips": 1, "why": "batch 8"})
    m["per_layer"].append({"name": "frames_per_batch", "unit": "frames",
                           "better": "higher", "source": "program_counter",
                           "layer": "executor", "moves": "frames_per_s",
                           "workloads": ["resnet34.offline.r3.b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

    cell = harness.resolve_cell(tmp_path, harness.load_manifest(tmp_path),
                                "resnet34.offline.r3.b8")
    assert cell.traffic["batch"] == 8
    assert [x["name"] for x in cell.per_layer] == ["frames_per_batch"]
    layers = harness.layers_of(tmp_path, cell.config)
    assert sum(lay["kind"] == "add" for lay in layers) == 16
    ctx = type("Ctx", (), {"frames_per_request": 8})()
    assert harness.reader(tmp_path, "frames_per_batch")(ctx) == 8
