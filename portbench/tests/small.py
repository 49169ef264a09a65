"""Cells of BENCHMARK.json at sizes a CPU test run can hold: every shape
kept but the data, the batch and the window."""

from portbench.bench import Spec, load_json

# conv_ae.train's entries, held back from BENCHMARK.json while its rate
# spreads wider than any bound allows (PERF.md, section 7); its files stay
# and are tested, so that it returns by these entries alone
HELD_BACK = {
    "configs": [{"name": "conv_ae", "source": "https://github.com/Computational-Biology-TUe/ae_waveforms",
                 "file": "portbench/configs/conv_ae.json", "reduced": ["epochs"],
                 "why": "the reference's LeNet5AutoencoderAvgPool at latent 10: the same trainer with no LSTM"}],
    "workloads": [{"name": "conv_ae.train", "config": "conv_ae", "traffic": "train", "chips": 1,
                   "why": "the same trainer and entry with no LSTM: about 50 small launches a step"}],
    "metrics": ["train_beats_per_s", "train_mfu", "idle_share.train"],
}


def spec() -> Spec:
    """BENCHMARK.json with the held-back entries added."""
    s = Spec()
    for key in ("configs", "workloads"):
        known = {e["name"] for e in s.data[key]}
        s.data[key] += [e for e in HELD_BACK[key] if e["name"] not in known]
    for m in s.data["end_to_end"] + s.data["per_layer"]:
        if m["name"] in HELD_BACK["metrics"] and "conv_ae.train" not in m["workloads"]:
            m["workloads"] = m["workloads"] + ["conv_ae.train"]
    return s


def small_cell(name: str, **overrides):
    s = spec()
    w = {x["name"]: x for x in s.data["workloads"]}[name]
    config = load_json(s.root / {c["name"]: c for c in s.data["configs"]}[w["config"]]["file"])
    traffic = load_json(s.root / "portbench" / "traffic" / f"{name}.json")
    if traffic["driver"] == "train":
        config.update(batch_size=16, validation_interval=4)
        traffic.update(beats=2000, case_ids=500, warm_steps=9, trace_steps=[5, 9])
    else:
        config.update(gs_candidates=1, gs_random_state=4)
        traffic.update(rows_per_class=160, searched_per_class=100, test_per_class=50, warm_trees=1,
                       trace_trees=[1, 2])
    traffic.update(overrides)
    return s.cell(name, traffic=traffic, config=config)
