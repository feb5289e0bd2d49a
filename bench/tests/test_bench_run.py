"""``bench/run.py`` at a tiny size on the CPU: the command refuses to run
without a card, and the rest of a run (set-up, loop, window, trace and
the check) works on every cell's path."""

import json
import os
import subprocess
import sys

import _bench_tiny
import pytest

from bench import run, spec


def test_command_names_the_missing_card():
    """Where torch sees no card the run exits non-zero, says why, and
    prints no result and no device number."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, str(_bench_tiny.ROOT / "bench" / "run.py"),
         "--workload", "granite8b-dither-chat", "--seed", str(2**31 + 9),
         "--seconds", "1", "--trace", "0"],
        cwd=_bench_tiny.ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert p.returncode != 0
    assert "CUDA card" in p.stderr
    assert "{" not in p.stdout and "memory_peak_bytes" not in p.stdout


@pytest.mark.parametrize("cell", _bench_tiny.CELLS)
def test_tiny_run_of_each_cell(cell):
    res = _bench_tiny.run_tiny(cell, seed=2**31 + 3)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    line = run.result_line(res, spec.manifest(), cell, False)
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"output_tok_s", "ttft_p90_ms",
                                    "tpot_p90_ms", "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    json.dumps(line)


def test_traced_tiny_run():
    cell = "granitemoe-prefix-chat"
    res = _bench_tiny.run_tiny(cell, trace=True)
    line = run.result_line(res, spec.manifest(), cell, True)
    # the host-only trace finds no device operations: those metrics are
    # left out, never reported as 0
    assert {"prefill_tok_s", "decode_ms_per_tick",
            "prefix_hit_share"} <= set(line["metrics"])
    assert "device_idle_share" not in line["metrics"]
    assert 0 < line["metrics"]["prefix_hit_share"]["value"] <= 100
    assert line["breakdown"] == {"device_ops": [], "idle_gaps": []}
    sl = res["run"].slice
    assert sl["ticks"] > 0 and sl["requests"]
    # the slice lasts its span and holds a prefill wave and a window
    assert sl["seconds"] >= 0.2 and sl["steps"] >= 1
    assert sl["stats"]["prefill_tokens"] > 0
