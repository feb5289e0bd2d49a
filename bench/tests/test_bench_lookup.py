"""The harness finds a configuration's mix, cell check, per-layer metric
and kind of work by name: a new mix and a new metric are new files and
manifest entries, and no existing file changes."""

import json
import shutil

import _bench_tiny
import pytest

from bench import spec
from bench.context import Run


@pytest.fixture
def checkout(tmp_path):
    """A copy of the manifest and the benchmark's files, plus a dummy mix,
    cell, metric and kind of work added as files of their own."""
    root = tmp_path / "co"
    shutil.copytree(_bench_tiny.ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = spec.manifest()
    man["workloads"].append({"name": "dummy-cell", "config": "granite-3-8b",
                             "traffic": "dummy_mix", "chips": 1,
                             "why": "a test"})
    man["per_layer"].append({"name": "dummy_metric", "unit": "%",
                             "better": "higher", "source": "device_trace",
                             "layer": "device", "moves": "output_tok_s",
                             "workloads": ["dummy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    b = root / "bench"
    mix = dict(_bench_tiny.traffic("x"), about="dummy")
    (b / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (b / "cells" / "dummy-cell.json").write_text(json.dumps(
        {"tokens": 10, "limits": {"mean_gap": 1.0},
         "control": {"matmul": "fp8"}}))
    (b / "metrics" / "dummy_metric.py").write_text(
        "def read(run):\n    return run.work('dummy_work')['seconds']\n")
    (b / "roofline" / "dummy_work.py").write_text(
        "def work(run):\n    return {'seconds': 42.0}\n")
    (b / "roofline" / "dummy_work.new_kernel.json").write_text(
        json.dumps(["my_kernel"]))
    return root


def test_new_files_are_found(checkout):
    man = spec.manifest(checkout)
    c = spec.cell("dummy-cell", man, root=checkout)
    assert c["traffic"]["about"] == "dummy"
    assert c["config"]["name"] == "granite-3-8b"
    assert c["check"]["limits"] == {"mean_gap": 1.0}
    names = [m["name"] for m in spec.metrics_for(man["per_layer"],
                                                 "dummy-cell")]
    assert "dummy_metric" in names and "prefix_hit_share" not in names
    read = spec.metric_reader("dummy_metric", bench=checkout / "bench")
    assert spec.kernel_names("dummy_work", bench=checkout / "bench") == \
        ["my_kernel"]

    class R(Run):
        def work(self, work):
            return spec.work_counter(work, bench=checkout / "bench")(self)
    assert read(R("dummy-cell", {}, c["traffic"], None)) == 42.0


def test_the_manifests_names_resolve():
    man = spec.manifest()
    for w in man["workloads"]:
        c = spec.cell(w["name"], man)
        assert c["traffic"]["engine"]["slots"] > 0
        assert c["check"]["limits"] and c["check"]["control"]
        assert set(c["check"]["limits"]) <= {"widest_gap", "mean_gap",
                                             "product_mismatch"}
        assert ("product_mismatch" in c["check"]["limits"]) == \
            ("products" in c["check"])
    for m in man["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    for w in ("dither_matmul", "attention", "model"):
        assert callable(spec.work_counter(w))


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")
