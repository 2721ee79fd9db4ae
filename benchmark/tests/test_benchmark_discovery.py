"""A configuration, a traffic mix and a metric dropped into a copy of the
benchmark are found by name, with no file that is there edited."""
import hashlib
import json
import shutil

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
