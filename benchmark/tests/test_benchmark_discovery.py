"""A configuration, a traffic mix and a metric dropped into a copy of the
benchmark are found by name, with no file that is there edited; so are the
published recipes whose heads the benchmark has no cell of yet."""
import hashlib
import json
import shutil

import pytest

from benchmark import harness
from benchmark.tests import tiny

READER = '''"""Audio seconds a batch (a test metric)."""


def read(ctx):
    units = ctx["run"].units()
    return sum(t for _, t in units) / len(units) / ctx["keys"]["sample_rate"]
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_files_are_found_without_edits(tmp_path):
    shutil.copytree(harness.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(harness.ROOT / "BENCHMARK.json"))
    before = _digests(tmp_path / "benchmark")
    b = tmp_path / "benchmark"
    shutil.copy(b / "configs" / "flagship.json", b / "configs" / "copy.json")
    mix = json.load(open(b / "traffic" / "synth_batch.json"))
    json.dump(dict(mix, batch=3), open(b / "traffic" / "synth_b3.json", "w"))
    json.dump({"token_gap": 1.0}, open(b / "limits" / "synth.copy.b3.json", "w"))
    (b / "metrics" / "audio_per_batch.synth.py").write_text(READER)
    bench["configs"].append(dict(bench["configs"][0], name="copy",
                                 file="benchmark/configs/copy.json"))
    bench["workloads"].append({"name": "synth.copy.b3", "config": "copy",
                               "traffic": "synth_b3", "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "audio_per_batch.synth", "unit": "s",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "synth_audio_s_per_s",
                               "workloads": ["synth.copy.b3"]})
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    out = tiny.run("synth.copy.b3", root=tmp_path, trace=True)
    assert out["correct"]
    assert "audio_per_batch.synth" in out["metrics"]
    cell = harness.load_cell("synth.copy.b3", tmp_path)
    assert cell.traffic["batch"] == 3 and cell.config["name"]
    after = _digests(b)
    assert all(after[k] == v for k, v in before.items())


# the recipes of the reference's other heads: a 256-way categorical over
# mu-law codes with one-hot input, and a single Gaussian
RECIPES = {"mulaw256": "egs/mulaw256/conf/mulaw256_wavenet.json",
           "gaussian": "egs/gaussian/conf/gaussian_wavenet.json"}
SOURCE = "https://github.com/r9y9/wavenet_vocoder/blob/master/"
# each new cell beside the flagship cell of its traffic, whose metrics it takes
RECIPE_CELLS = {"synth_batch": ("synth.{}.b256", "synth.flagship.b256"),
                "stream_segments": ("stream.{}.b1", "stream.flagship.b1")}


def add_recipe_cells(root):
    """A copy of the benchmark under ``root`` to which each recipe is added
    as new files alone: its configuration, as published, and a limits file
    for a cell on each existing traffic mix; BENCHMARK.json enters them.
    Returns the digests of the copy's files before the addition."""
    b = root / "benchmark"
    shutil.copytree(harness.ROOT / "benchmark", b,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(b)
    bench = json.load(open(harness.ROOT / "BENCHMARK.json"))
    for name, conf in RECIPES.items():
        keys = json.load(open(harness.ROOT / conf))
        json.dump(dict(keys, source=SOURCE + conf, reduced=[]),
                  open(b / "configs" / f"{name}.json", "w"), indent=1)
        bench["configs"].append({"name": name, "source": SOURCE + conf,
                                 "file": f"benchmark/configs/{name}.json",
                                 "reduced": [], "why": "t"})
        for traffic, (pattern, like) in RECIPE_CELLS.items():
            cell = pattern.format(name)
            json.dump({"token_gap": 0.12, "sampled_gap": 0.15},
                      open(b / "limits" / f"{cell}.json", "w"))
            bench["workloads"].append({"name": cell, "config": name,
                                       "traffic": traffic, "chips": 1,
                                       "why": "t"})
            for m in bench["end_to_end"] + bench["per_layer"]:
                if like in m.get("workloads", []):
                    m["workloads"].append(cell)
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    return before


@pytest.fixture(scope="module")
def recipes(tmp_path_factory):
    root = tmp_path_factory.mktemp("recipes")
    return root, add_recipe_cells(root)


RECIPE_RUNS = [p.format(n) for n in RECIPES for p, _ in RECIPE_CELLS.values()]


@pytest.mark.parametrize("name", RECIPE_RUNS)
def test_recipe_heads_are_added_as_new_files_alone(recipes, name):
    root, before = recipes
    out = tiny.run(name, root=root)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"token_gap", "sampled_gap"}
    assert out["check_all"]["token_gap_steps"] > 0
    assert out["check_all"]["sampled_gap_steps"] > 0
    after = _digests(root / "benchmark")
    assert all(after[k] == v for k, v in before.items())
