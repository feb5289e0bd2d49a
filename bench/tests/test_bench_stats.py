"""The end-to-end arithmetic on synthetic requests: a stall inside the
window has to move the rate and both tails."""

from types import SimpleNamespace

import _bench_tiny  # noqa: F401  (paths)
import pytest

from bench.stats import Window, end_to_end, percentile


def _req(rid, t_submit, t_first, gap, n, reason="length", max_new=None):
    return SimpleNamespace(
        rid=rid, t_submit=t_submit, t_first=t_first,
        t_last=t_first + gap * (n - 1), out=[0] * n, done=True,
        finish_reason=reason, max_new=n if max_new is None else max_new)


def _traffic(stall: float):
    """20 requests, one every 0.5 s, 10 tokens 0.05 s apart; from t = 5 s
    on everything happens ``stall`` seconds later."""
    reqs = []
    for i in range(20):
        t = 0.5 * i
        shift = stall if t >= 5.0 else 0.0
        reqs.append(_req(i, t, t + 0.1 + shift, 0.05 + shift / 9, 10))
    return reqs


def _emitted_by(r, t):
    """Tokens ``r`` had at time t: its i-th at t_first + i · gap."""
    if t < r.t_first:
        return 0
    if len(r.out) == 1:
        return 1
    gap = (r.t_last - r.t_first) / max(len(r.out) - 1, 1)
    return min(len(r.out), 1 + int((t - r.t_first) / gap + 1e-9))


def _window(reqs, t1=20.0):
    return Window(0.0, t1, {r.rid: 0 for r in reqs},
                  {r.rid: _emitted_by(r, t1) for r in reqs})


def test_percentile_is_linear():
    assert percentile([], 90) is None
    assert percentile([1.0, 2.0, 3.0, 4.0, 5.0], 90) == pytest.approx(4.6)


def test_plain_window():
    reqs = _traffic(0.0)
    m = end_to_end(reqs, _window(reqs))
    assert m["output_tok_s"] == pytest.approx(200 / 20.0)
    assert m["ttft_p90_ms"] == pytest.approx(100.0)
    assert m["tpot_p90_ms"] == pytest.approx(50.0)
    assert (m["attempted"], m["failed"]) == (20, 0)


def test_stall_moves_rate_and_tails():
    calm, stalled = _traffic(0.0), _traffic(2.0)
    a = end_to_end(calm, _window(calm, 12.0))
    b = end_to_end(stalled, _window(stalled, 12.0))
    assert b["output_tok_s"] < a["output_tok_s"]
    assert b["ttft_p90_ms"] > a["ttft_p90_ms"] + 1000
    assert b["tpot_p90_ms"] > a["tpot_p90_ms"]


def test_only_the_window_counts():
    reqs = _traffic(0.0)
    win = Window(2.0, 6.0, {r.rid: len(r.out) if r.t_last < 2.0 else 0
                            for r in reqs},
                 {r.rid: len(r.out) if r.t_first <= 6.0 else 0
                  for r in reqs})
    m = end_to_end(reqs, win)
    assert m["n_ttft"] == sum(1 for r in reqs if 2.0 <= r.t_first <= 6.0)
    assert m["attempted"] == sum(1 for r in reqs if 2.0 <= r.t_last <= 6.0)


def test_short_or_refused_requests_fail():
    reqs = [_req(0, 0.0, 0.1, 0.05, 10),
            _req(1, 0.0, 0.1, 0.05, 4, max_new=10),
            _req(2, 0.0, 0.1, 0.05, 1, reason="rejected")]
    m = end_to_end(reqs, _window(reqs))
    assert (m["attempted"], m["failed"]) == (3, 2)
