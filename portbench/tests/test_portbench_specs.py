"""Every part of every cell is found by name, and a cell, a configuration,
a traffic mix and a per-layer metric are added by adding files only."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import spec
from portbench.spec import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(cell):
    c = spec.load_cell(cell)
    assert c.config["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    assert hasattr(spec.driver(c.traffic["kind"]), "run")
    assert c.limits, "every cell has correctness limits"
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in names


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_loads_by_name(metric):
    assert callable(spec.reader(spec.quantity(metric)).read)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file_holds_the_run(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    cfg = spec.load_json(ROOT / entry["file"])
    assert cfg["name"] == config and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    for group in ("model", "cache", "runtime", "init"):
        assert group in cfg


def _copy(tmp):
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return json.loads((tmp / "BENCHMARK.json").read_text())


def test_new_cell_config_traffic_and_metric_are_files_only(tmp_path):
    """In a copy: a new configuration, traffic mix, limits file and
    per-layer metric reader, plus entries in BENCHMARK.json, make a cell
    that loads and a metric that reads, with no file of the copy edited."""
    bench = _copy(tmp_path)
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "yi-9b-200k.json").read_text())
    cfg["name"] = "yi-9b-200k-copy"
    (pb / "configs" / "yi-9b-200k-copy.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "traffic" / "rounds-32k-b8.json").read_text())
    traffic["batch"] = 16
    (pb / "traffic" / "rounds-32k-b16.json").write_text(json.dumps(traffic))
    (pb / "limits" / "yi-copy.decode-32k-b16.json").write_text(
        json.dumps({"gap": 1.0}))
    (pb / "metrics" / "steps_traced.py").write_text(
        "def read(obs):\n    return float(len(obs.get('depths', [])))\n")
    bench["configs"].append({"name": "yi-9b-200k-copy", "source": cfg["source"],
                             "file": "portbench/configs/yi-9b-200k-copy.json",
                             "reduced": [], "why": "copy"})
    bench["workloads"].append({"name": "yi-copy.decode-32k-b16",
                               "config": "yi-9b-200k-copy",
                               "traffic": "rounds-32k-b16", "chips": 1,
                               "why": "copy"})
    bench["per_layer"].append({"name": "steps_traced", "unit": "steps",
                               "better": "higher", "source": "program_counter",
                               "layer": "harness", "moves": "decode_tok_s",
                               "workloads": ["yi-copy.decode-32k-b16"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] != "prefill_tok_s":
            m["workloads"].append("yi-copy.decode-32k-b16")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
    code = ("from pathlib import Path; from portbench import spec; "
            "c = spec.load_cell('yi-copy.decode-32k-b16', Path('.')); "
            "assert c.traffic['batch'] == 16 and c.limits == {'gap': 1.0}; "
            "assert spec.driver(c.traffic['kind']).__name__.endswith("
            "'decode_rounds'); "
            "m = [x['name'] for x in c.per_layer]; "
            "assert 'steps_traced' in m, m; "
            "assert spec.reader('steps_traced').read({'depths': [1, 2]}) == 2.0;"
            " print('ok')")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path),
                                                       str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr
