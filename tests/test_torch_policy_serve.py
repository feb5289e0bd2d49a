"""Serving under the paper's quantised-matmul policy: the port's
``Engine(policy=QuantPolicy(...))`` at ``smollm_135m.reduced()``, against
the reference's engine on the same weights, and the engine contracts the
policy changes.

* **Streams.**  Under a policy the port's logits are within
  ``POLICY_LOGIT_TOL`` (2⁻³, ``tests/test_torch_policy.py``) of the
  reference's: the quantiser's tensor-global absmax turns the port's
  ulp-level differences before it into a shifted grid.  Equal streams are
  then a fair demand only where every decision of the reference clears
  twice that: each test records every logit row the reference's sampler
  sees and checks it with ``test_torch_serve._check_decision`` first.  At
  that margin greedy decisions of the reduced model almost never clear, so
  the fixtures sample at temperature 2, where the deciding scores are
  Gumbel-spread; a fixture that fails the check is reseeded, never
  loosened.
* **One prefill per admission wave** under a policy, as the reference
  makes (the activation operand of each fused product is the whole call,
  so splitting a wave by length bucket would change every stream), and
  the policy-free path's per-bucket split unchanged.
* **The prefix cache** is off under a counter-dependent scheme and on
  under the deterministic one, as the reference gates it.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_serve import _check_decision

import repro.serve.engine as ref_engine
import repro_torch.serve.engine as port_engine
from repro.configs import get_config
from repro.models import registry as ref_registry
from repro.numerics.policy import QuantPolicy as RefPolicy
from repro_torch.configs import get_config as port_get_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.models import registry
from repro_torch.numerics.policy import QuantPolicy
from repro_torch.serve import Engine, Request, SamplingParams
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = get_config("smollm_135m").reduced()
PCFG = port_get_config("smollm_135m").reduced()
PARAMS = ref_registry.init_model(jax.random.PRNGKey(0), CFG)
TORCH_PARAMS = params_from_numpy(jax.tree.map(np.asarray, PARAMS), "cpu")
POLICY_LOGIT_TOL = 2.0 ** -3     # port vs reference logits under a policy
TEMPERATURE = 2.0
MAX_NEW = (2, 3, 2, 3)            # by rid


def _requests(seed, mod, n=4, shared=0):
    """``n`` sampled requests (temperature 2, full vocabulary) with prompts
    of 3..23 tokens from ``seed`` (after ``shared`` common tokens), one
    counter offset each."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, CFG.vocab_size, size=shared).tolist()
    reqs = []
    for r in range(n):
        prompt = prefix + rng.integers(
            1, CFG.vocab_size, size=int(rng.integers(3, 24))).tolist()
        sp = mod.SamplingParams(temperature=TEMPERATURE, top_k=0,
                                seed=seed + r, max_new=MAX_NEW[r % 4],
                                counter_offset=1000 * r)
        reqs.append(mod.Request(rid=r, prompt=prompt, sampling=sp))
    return reqs


def _reference(seed, monkeypatch, **kw):
    """The reference engine under ``RefPolicy(scheme='dither',
    backend='xla-ref')`` with its sampler recording every call; every
    deciding row (the rows a prefill wave admitted, else every occupied
    slot) must clear ``POLICY_LOGIT_TOL``.  Returns the streams."""
    calls, holder = [], {}

    def record(*arrays):
        slots = holder["engine"].slots
        fresh = any(s is not None and not s.out for s in slots)
        decide = [s is not None and (not s.out if fresh else True)
                  for s in slots]
        calls.append(([np.array(a) for a in arrays], decide))

    def sample(*args):
        jax.debug.callback(record, *args)
        return original(*args)

    original = ref_engine.sample_tokens
    monkeypatch.setattr(ref_engine, "sample_tokens", sample)
    holder["engine"] = eng = ref_engine.Engine(
        PARAMS, CFG, batch=2, max_len=32,
        policy=RefPolicy(scheme="dither", backend="xla-ref"), **kw)
    for req in _requests(seed, ref_engine):
        eng.submit(req)
    done = sorted(eng.run(100), key=lambda r: r.rid)
    monkeypatch.undo()
    decisions = 0
    for i, ((logits, temps, topks, seeds, counters), decide) in enumerate(
            calls):
        for b in np.flatnonzero(decide):
            decisions += 1
            _check_decision(logits[b], temps[b], topks[b], seeds[b],
                            counters[b], POLICY_LOGIT_TOL,
                            context=f"call {i} row {b}")
    assert decisions == sum(MAX_NEW)
    return [(r.rid, r.finish_reason, r.out) for r in done]


def _port(seed, **kw):
    eng = Engine(TORCH_PARAMS, PCFG, 2, 32, device="cpu",
                 policy=QuantPolicy(scheme="dither", backend="auto"), **kw)
    for req in _requests(seed, port_engine):
        eng.submit(req)
    done = sorted(eng.run(100), key=lambda r: r.rid)
    return eng, [(r.rid, r.finish_reason, r.out) for r in done]


@pytest.mark.parametrize("layout,kv_quant,seed", [
    ("ring", False, 3), ("ring", True, 3), ("paged", True, 3),
    ("ring", False, 4)])
def test_policy_engine_streams_equal_reference(layout, kv_quant, seed,
                                               monkeypatch):
    """The port's dither-policy streams (the plain version of the dither
    matmul on the CPU) equal the reference engine's (``xla-ref``), request
    by request, over the ring (bf16 and int8 KV) and the paged pool (int8),
    on margin-checked fixtures."""
    kw = dict(kv_quant=kv_quant, kv_layout=layout)
    if layout == "paged":
        kw["block_size"] = 8
    ref = _reference(seed, monkeypatch, **kw)
    eng, port = _port(seed, **kw)
    assert port == ref
    assert eng.policy.backend == "torch-ref"
    assert all(reason == "length" and len(out) == MAX_NEW[rid]
               for rid, reason, out in port)


# ---------------------------------------------------------------------------
# one prefill call per wave under a policy
# ---------------------------------------------------------------------------


class _Recorder:
    """Wraps an engine's prefill step: records each call's token shape and
    returns what the step returns."""

    def __init__(self, step):
        self.step, self.calls = step, []

    def __call__(self, *args, **kw):
        self.calls.append(tuple(args[1].shape))
        return self.step(*args, **kw)


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_one_prefill_call_per_wave_under_a_policy(layout):
    """A wave of prompts of 4 and 20 tokens (length buckets 8 and 32):
    under a policy one prefill call at the longest prompt's bucket, as the
    reference makes, and its first tokens are those of a direct one-call
    prefill of the whole wave; without a policy the same wave still runs
    one call per bucket."""
    prompts = [[5, 6, 7, 8], list(range(1, 21))]
    paged = dict(kv_layout="paged", block_size=8) if layout == "paged" else {}
    name = "_prefill_paged" if layout == "paged" else "_prefill"
    pol = QuantPolicy(scheme="dither", backend="torch-ref")
    firsts = {}
    for policy, calls in ((pol, [(2, 32)]), (None, [(2, 8), (2, 32)])):
        eng = Engine(TORCH_PARAMS, PCFG, 2, 32, device="cpu", policy=policy,
                     **paged)
        rec = _Recorder(getattr(eng, name))
        setattr(eng, name, rec)
        for r, p in enumerate(prompts):
            eng.submit(Request(rid=r, prompt=p, max_new=3))
        eng.step()
        assert rec.calls == calls, (policy, rec.calls)
        assert eng.stats["prefill_calls"] == len(calls)
        firsts[policy] = [s.out[0] for s in eng.slots]
    toks = torch.zeros((2, 32), dtype=torch.long)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p)
    logits, _ = registry.apply_prefill(
        TORCH_PARAMS, PCFG, toks, torch.tensor([4, 20], dtype=torch.int32),
        32, policy=pol, counter=0, kv_offset=torch.zeros(2, dtype=torch.int32))
    assert firsts[pol] == torch.argmax(logits, -1).tolist()


# ---------------------------------------------------------------------------
# the prefix cache under a policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme,enabled", [("dither", False),
                                            ("stochastic", False),
                                            ("deterministic", True),
                                            (None, True)])
def test_prefix_cache_only_without_counter_dependent_numerics(scheme,
                                                              enabled):
    """Requests sharing a 16-token prefix on a paged pool of 4-token
    blocks: the prefix cache (and its hits) only when prefill numerics
    depend on token and position alone — no policy, or the deterministic
    scheme — as the reference's engine gates it."""
    policy = None if scheme is None else QuantPolicy(scheme=scheme,
                                                     backend="auto")
    ref_policy = None if scheme is None else RefPolicy(scheme=scheme,
                                                       backend="xla-ref")
    eng = Engine(TORCH_PARAMS, PCFG, 2, 64, device="cpu", policy=policy,
                 kv_layout="paged", block_size=4)
    ref_eng = ref_engine.Engine(PARAMS, CFG, batch=2, max_len=64,
                                policy=ref_policy, kv_layout="paged",
                                block_size=4)
    assert eng.pool.prefix_cache == ref_eng._prefix_enabled == enabled
    for r, req in enumerate(_requests(3, port_engine, n=4, shared=16)):
        eng.submit(req)
    eng.run(100)
    assert (eng.stats["prefix_hit_tokens"] > 0) == enabled
    assert sorted((r.rid, len(r.out)) for r in eng.finished) == [
        (r, MAX_NEW[r]) for r in range(4)]


# ---------------------------------------------------------------------------
# the policy engine: its counter, restarts, gates, the launcher
# ---------------------------------------------------------------------------


def test_policy_engine_counter_is_the_tick_and_restarts_replay():
    """The policy's counter is the engine tick: the same greedy traffic on
    a fresh engine replays every token, and serving it from a later tick
    (``tick`` moved on) changes the streams."""
    def run(tick0=0):
        eng = Engine(TORCH_PARAMS, PCFG, 2, 32, device="cpu",
                     policy=QuantPolicy(scheme="dither", backend="auto"),
                     kv_quant=True)
        eng.tick = tick0
        for r in range(4):
            eng.submit(Request(rid=r, prompt=[3 + r, 9, 27, 81, 243],
                               max_new=8))
        return [r.out for r in sorted(eng.run(100), key=lambda r: r.rid)]

    first = run()
    assert run() == first
    assert run(tick0=7) != first


def test_policy_resolves_once_for_the_engine_device():
    """``Engine`` resolves ``auto`` to the CPU's ``torch-ref`` once; the
    unfused ``torch`` backend stays; a bogus backend raises at build."""
    for backend, want in (("auto", "torch-ref"), ("torch", "torch"),
                          ("torch-ref", "torch-ref")):
        eng = Engine(TORCH_PARAMS, PCFG, 2, 16, device="cpu",
                     policy=QuantPolicy(scheme="dither", backend=backend))
        assert eng.policy.backend == want
    with pytest.raises(ValueError, match="unknown kernel backend"):
        Engine(TORCH_PARAMS, PCFG, 2, 16, device="cpu",
               policy=QuantPolicy(scheme="dither", backend="pallas"))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        eng = Engine(TORCH_PARAMS, PCFG, 2, 16, device="cpu",
                     policy=QuantPolicy(scheme="dither", backend="cuda"))
        eng.submit(Request(rid=0, prompt=[1, 2, 3], max_new=1))
        eng.run(5)
    assert dispatch.resolve_policy_backend("auto", "cpu") == "torch-ref"


@pytest.mark.parametrize("policy,backend", [("dither", "auto"),
                                            ("deterministic", "torch"),
                                            ("stochastic", "torch-ref")])
def test_launcher_policy_flags(policy, backend, capsys):
    """``python -m repro_torch.launch.serve --policy … --kernel-backend …``
    on the reduced model, on the CPU, ring and paged: every request
    finishes with its budget."""
    from repro_torch.launch.serve import serve_main

    for extra in ([], ["--kv-layout", "paged", "--max-len", "32",
                       "--block-size", "8", "--kv-quant"]):
        serve_main(["--arch", "smollm_135m", "--reduced", "--device", "cpu",
                    "--requests", "3", "--batch", "2", "--max-new", "3",
                    "--policy", policy, "--kernel-backend", backend] + extra)
        out = capsys.readouterr().out
        assert out.count("[length]") == 3
        assert "served 3/3 requests" in out
    with pytest.raises(SystemExit):
        serve_main(["--arch", "smollm_135m", "--reduced", "--device", "cpu",
                    "--policy", "bogus"])
