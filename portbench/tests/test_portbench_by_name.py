"""A configuration, a traffic mix and a per-layer metric added as new files,
with new entries in BENCHMARK.json, are found by their names: no file the
benchmark has is edited."""

import hashlib
import json
import shutil
from pathlib import Path

from portbench.bench import Spec
from portbench.run import Reading

ROOT = Path(__file__).resolve().parents[2]


def digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_config_and_metric_are_files(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = digests(tmp_path)

    config = json.loads((ROOT / "portbench/configs/lstm_ae.json").read_text())
    config.update(name="lstm_ae_l20", latent_size=20)
    (tmp_path / "portbench/configs/lstm_ae_l20.json").write_text(json.dumps(config))
    traffic = json.loads((ROOT / "portbench/traffic/lstm_ae.train.json").read_text())
    traffic.update(warm_steps=401)
    (tmp_path / "portbench/traffic/lstm_ae_l20.train.json").write_text(json.dumps(traffic))
    (tmp_path / "portbench/metrics/steps_taken.train.py").write_text(
        "def read(run):\n    steps = run.records.get('steps')\n    return float(steps) if steps else None\n")
    spec["configs"].append({"name": "lstm_ae_l20", "source": "https://example.org/l20",
                            "file": "portbench/configs/lstm_ae_l20.json", "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "lstm_ae_l20.train", "config": "lstm_ae_l20", "traffic": "train",
                              "chips": 1, "why": "test"})
    spec["end_to_end"][0]["workloads"].append("lstm_ae_l20.train")
    spec["per_layer"].append({"name": "steps_taken.train", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "trainer", "moves": "train_beats_per_s",
                              "workloads": ["lstm_ae_l20.train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    after = digests(tmp_path)
    assert all(after[p] == d for p, d in before.items())
    cell = Spec(tmp_path).cell("lstm_ae_l20.train")
    assert cell.config["latent_size"] == 20 and cell.traffic["warm_steps"] == 401
    assert cell.driver_module().__file__ == str(tmp_path / "portbench/drivers/train.py")
    assert [m["name"] for m in cell.end_to_end] == ["train_beats_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["steps_taken.train"]
    reading = Reading(cell=cell, device_name="cpu", trace=None, records={"steps": 1201})
    assert cell.reader("steps_taken.train").read(reading) == 1201.0
