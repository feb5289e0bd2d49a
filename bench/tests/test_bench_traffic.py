"""The traffic generator: seeded, within its clips, greedy requests of an
exact length, and the system-prompt draw."""

import collections

import _bench_tiny  # noqa: F401  (paths)
import pytest

from bench import spec
from bench.traffic import Traffic, buckets

MIXES = ("dither_chat", "prefix_chat", "int8kv_long", "bf16_long")


def _mix(name):
    return spec._json(spec.BENCH / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    a, b = Traffic(_mix(name), 2**31 + 7, 49155), \
        Traffic(_mix(name), 2**31 + 7, 49155)
    for c in range(3):
        for k in range(3):
            assert a.request(c, k) == b.request(c, k)
    assert a.warmup() == b.warmup()


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_same_work_other_tokens(name):
    """Another seed sends the same lengths (its clients take the streams in
    another order) with other token ids."""
    mix = _mix(name)
    a, b = Traffic(mix, 1, 49155), Traffic(mix, 2**33 + 5, 49155)

    def work(t):
        return sorted((len(r.prompt), r.max_new)
                      for r in (t.request(c, k) for c in range(t.clients)
                                for k in range(4)))
    assert work(a) == work(b)
    assert a.request(0, 0).prompt != b.request(0, 0).prompt


@pytest.mark.parametrize("name", MIXES)
def test_lengths_within_clips(name):
    mix = _mix(name)
    t = Traffic(mix, 99, 49155)
    pre = (mix.get("shared_prefix") or {}).get("tokens", 0)
    for c in range(t.clients):
        for k in range(20):
            r = t.request(c, k)
            own = len(r.prompt) - pre
            assert mix["prompt"]["min"] <= own <= mix["prompt"]["max"]
            assert mix["output"]["min"] <= r.max_new <= mix["output"]["max"]
            assert all(1 <= x < 49155 for x in r.prompt)


def test_quantiles_follow_the_median():
    mix = _mix("dither_chat")
    t = Traffic(mix, 5, 49155)
    own = sorted(len(t.request(c, k).prompt) for c in range(32)
                 for k in range(16))
    med = own[len(own) // 2]
    assert abs(med - mix["prompt"]["median"]) <= 0.1 * mix["prompt"]["median"]


def test_requests_are_greedy_exact_length():
    from bench import program
    req = program.make_request(3, [5, 6, 7], 17)
    sp = req.sampling
    assert req.max_new == sp.max_new == 17
    assert sp.temperature == 0.0 and sp.eos_id is None
    assert sp.stop_ids == () and not sp.stop_set()


def test_system_prompt_draw():
    mix = _mix("prefix_chat")
    t = Traffic(mix, 123, 49155)
    sp = mix["shared_prefix"]
    assert len(t.prefixes) == sp["count"]
    assert all(len(p) == sp["tokens"] for p in t.prefixes)
    counts = collections.Counter()
    for c in range(t.clients):
        for k in range(40):
            r = t.request(c, k)
            assert r.prompt[:sp["tokens"]] == t.prefixes[r.prefix]
            counts[r.prefix] += 1
    n = sum(counts.values())
    want = [1 / (i + 1) for i in range(sp["count"])]
    for i, w in enumerate(want):
        assert abs(counts[i] / n - w / sum(want)) < 0.02


def test_priming_staggers_the_first_outputs():
    t = Traffic(_mix("dither_chat"), 8, 49155)
    full = [t.request(c, 0).max_new for c in range(t.clients)]
    cut = [t.request(c, 0, residual=True).max_new for c in range(t.clients)]
    assert all(1 <= x <= f for x, f in zip(cut, full))
    assert len(set(cut)) > t.clients // 2


def test_warmup_covers_every_bucket():
    mix = _mix("dither_chat")
    t = Traffic(mix, 1, 49155)
    got = sorted({buckets(len(r.prompt), len(r.prompt))[0]
                  for r in t.warmup()})
    assert got == buckets(mix["prompt"]["min"], mix["prompt"]["max"])
    p = Traffic(_mix("prefix_chat"), 1, 49155).warmup()
    n = _mix("prefix_chat")["shared_prefix"]["count"]
    assert [r.prefix for r in p[:n]] == list(range(n))
