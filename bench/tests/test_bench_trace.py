"""The traced slice's arithmetic on a synthetic trace: the union of
device intervals, the heaviest operations, and idle gaps put down to
what the loop's thread was doing."""

import _bench_tiny  # noqa: F401  (paths)
import pytest

from bench.trace import Slice, covers, summarise

MS = 1_000_000


def test_busy_ops_and_gaps():
    device = [("k1", 0, 2 * MS), ("k2", 1 * MS, 3 * MS),   # overlap: 0-3
              ("k1", 5 * MS, 6 * MS),                        # gap 3-5
              ("copy", 10 * MS, 11 * MS)]                    # gap 6-10
    host = [("bench.engine_step", 0, 8 * MS, True, 1),
            ("aten::item", 3 * MS, 5 * MS, False, 1),
            ("bench.submit", 8 * MS, 11 * MS, True, 1),
            ("other thread", 0, 11 * MS, False, 2)]
    s = summarise(Slice(0.011, device, host))
    assert s["busy_s"] == pytest.approx(0.005)
    assert s["device_ops"][0] == ["k1", pytest.approx(0.003)]
    gaps = dict(s["idle_gaps"])
    assert gaps["bench.engine_step > aten::item"] == pytest.approx(0.002)
    # the 6-10 ms gap's midpoint (8 ms) opens bench.submit
    assert gaps["bench.submit"] == pytest.approx(0.004)
    assert "other thread" not in " ".join(gaps)


def test_empty_trace():
    s = summarise(Slice(1.0, [], []))
    assert s["busy_s"] == 0 and s["device_ops"] == [] and \
        s["idle_gaps"] == []


def test_a_slice_covers_a_wave_and_a_window():
    at = {"stats": {"prefill_tokens": 100}, "tick": 40}
    assert covers(at, {"stats": {"prefill_tokens": 612}, "tick": 48})
    assert not covers(at, {"stats": {"prefill_tokens": 100}, "tick": 64})
    assert not covers(at, {"stats": {"prefill_tokens": 612}, "tick": 40})
