"""The port's ring ``Engine`` against the reference's ``repro.serve.Engine``
on the same weights (carried over with ``interop.params_from_numpy``):
FCFS and priority admission, bf16 and int8-dither KV, mixed greedy and
temperature requests.  The emitted token streams must be equal.

The reference runs as it serves, jitted.  XLA keeps excess f32 precision
through some bf16 intermediates, and the two sides sum in different
orders, so the port's logits are within ``LOGIT_TOL`` (2⁻⁶, held in
``tests/test_torch_model.py``) of the reference's, not equal.  Equal
streams are then a fair demand only where every decision of the reference
clears twice that error.  So each test first records every logit row the
reference's sampler sees and checks with ``conftest.assert_argmax_margin``
that the deciding score — the logits for greedy rows, ``masked logits / T
+ gumbel`` for sampled rows — leads its runner-up by more than twice the
error, and that a sampled row's winner does not sit on the top-k boundary.
A fixture that fails the margin check is reseeded, never loosened.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import assert_argmax_margin

import repro.serve.engine as ref_engine
import repro_torch.serve.engine as port_engine
from repro.configs import get_config
from repro.core import rounding as ref_rounding
from repro.models import registry as ref_registry
from repro_torch.configs import get_config as port_get_config
from repro_torch.interop import params_from_numpy

CFG = get_config("smollm_135m").reduced()
PORT_CFG = port_get_config("smollm_135m").reduced()
PARAMS = ref_registry.init_model(jax.random.PRNGKey(0), CFG)
TORCH_PARAMS = params_from_numpy(jax.tree.map(np.asarray, PARAMS), "cpu")
LOGIT_TOL = 2.0 ** -6       # port vs reference logits (test_torch_model.py)
BATCH, MAX_LEN = 2, 64
# (temperature, top_k, max_new, priority) by rid: one greedy request, three
# sampled; priority admission takes rids 1 and 3 first, FCFS rids 0 and 1,
# and the short requests free their slots while the long ones decode
SAMPLING = [(0.0, 0, 2, 0), (0.8, 0, 4, 2), (0.8, 40, 2, 1), (0.8, 0, 4, 2)]


def _requests(seed, mod):
    """One request per ``SAMPLING`` row, prompts of 3..23 tokens from
    ``seed``."""
    rng = np.random.default_rng(seed)
    reqs = []
    for r, (temp, top_k, max_new, priority) in enumerate(SAMPLING):
        prompt = rng.integers(1, CFG.vocab_size,
                              size=int(rng.integers(3, 24))).tolist()
        sp = mod.SamplingParams(temperature=temp, top_k=top_k, seed=seed + r,
                                max_new=max_new, counter_offset=1000 * r)
        reqs.append(mod.Request(rid=r, prompt=prompt, sampling=sp,
                                priority=priority))
    return reqs


def _check_decision(logits, temp, top_k, seed, counter, tol, context):
    """Assert one row's sampling decision survives a logit error of
    ``tol``.  Greedy: the top-2 logit gap exceeds twice the error.
    Sampled: the other side's top-k set may differ from this one only by
    logits within 2·tol of the k-th largest, so the deciding scores
    ``logits / T + gumbel`` are taken over the widest such set, their top-2
    gap must exceed twice the error in them (2·tol / T), and fewer than k
    other logits may lie above the winner's less 2·tol, so that it is in
    every such set."""
    if temp <= 0:
        assert_argmax_margin(logits, min_margin=2 * tol,
                             context=f"greedy {context}")
        return
    v = logits.shape[-1]
    k = min(int(top_k), v) if top_k > 0 else v
    thresh = np.sort(logits)[v - k] if k < v else -np.inf
    u = np.asarray(ref_rounding.hash_uniform(
        int(seed), jnp.arange(v, dtype=jnp.uint32), int(counter)))
    gumbel = -np.log(-np.log(u + 1e-12) + 1e-12)
    wide = np.where(logits >= thresh - 2 * tol, logits, -np.inf)
    scores = wide / max(float(temp), 1e-6) + gumbel
    assert_argmax_margin(scores, min_margin=2 * tol / temp,
                         context=f"sampled {context}")
    rivals = np.sum(logits > logits[np.argmax(scores)] - 2 * tol) - 1
    assert rivals < k, (
        f"sampled {context}: the winner sits on the top-k boundary — "
        "reseed the fixture")


def _reference(seed, sched, kv_quant, monkeypatch):
    """Run the reference engine with its sampler recording, per call, the
    sampler's inputs and which rows decide a token of the stream (the rows
    a prefill wave admitted, whose ``out`` is still empty, else every
    occupied slot); check every deciding row's margin; return the
    streams."""
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
        PARAMS, CFG, batch=BATCH, max_len=MAX_LEN, kv_quant=kv_quant,
        scheduler=sched)
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
                            counters[b], LOGIT_TOL,
                            context=f"call {i} row {b}")
    assert decisions == sum(row[2] for row in SAMPLING)
    return [(r.rid, r.finish_reason, r.out) for r in done]


def _port(seed, sched, kv_quant):
    eng = port_engine.Engine(TORCH_PARAMS, PORT_CFG, BATCH, MAX_LEN,
                             kv_quant=kv_quant, scheduler=sched,
                             device="cpu")
    for req in _requests(seed, port_engine):
        eng.submit(req)
    done = sorted(eng.run(100), key=lambda r: r.rid)
    return [(r.rid, r.finish_reason, r.out) for r in done]


@pytest.mark.parametrize("sched,kv_quant,seed", [
    ("fcfs", False, 23), ("priority", False, 23),
    ("fcfs", True, 23), ("priority", True, 23)])
def test_engine_streams_equal_reference(sched, kv_quant, seed, monkeypatch):
    """Greedy and temperature streams of the port's engine equal the
    reference engine's, request by request, on margin-checked fixtures."""
    ref = _reference(seed, sched, kv_quant, monkeypatch)
    port = _port(seed, sched, kv_quant)
    assert port == ref
    assert all(reason == "length" and len(out) == SAMPLING[rid][2]
               for rid, reason, out in port)


def test_priority_changes_admission_order(monkeypatch):
    """The fixture really exercises the scheduler: under priority the
    first wave is rids 1 and 3, under FCFS rids 0 and 1."""
    firsts = {}
    for sched in ("fcfs", "priority"):
        eng = port_engine.Engine(TORCH_PARAMS, PORT_CFG, BATCH, MAX_LEN,
                                 scheduler=sched, device="cpu")
        reqs = _requests(0, port_engine)
        for req in reqs:
            eng.submit(req)
        eng.step()
        firsts[sched] = [r.rid for r in reqs if r.t_admit is not None]
    assert firsts == {"fcfs": [0, 1], "priority": [1, 3]}


def test_sample_tokens_matches_reference():
    """``sample_tokens`` on identical f32 logits picks the reference's
    tokens, row by row: greedy, full-vocab and top-k sampling.  The logits
    are continuous, so only the Gumbel noise's f32 ``log`` may differ (by
    an ulp); each row's deciding scores clear 1e-4 first."""
    from repro.serve.sampling import sample_tokens as ref_sample
    from repro_torch.serve.sampling import sample_tokens

    rng = np.random.default_rng(0)
    b, v = 12, 512
    logits = rng.normal(size=(b, v)).astype(np.float32)
    temps = np.array([0, 0.8, 0.8, 0.8, 1.5, 0.3] * 2, np.float32)
    topks = np.array([0, 0, 40, 1, 5, 300] * 2, np.int32)
    seeds = rng.integers(0, 2**31, size=b).astype(np.int32)
    counters = rng.integers(-5, 10_000, size=b).astype(np.int32)
    for i in range(b):
        _check_decision(logits[i], temps[i], topks[i], seeds[i], counters[i],
                        5e-5, context=f"row {i}")
    want = np.asarray(ref_sample(*map(jnp.asarray, (logits, temps, topks,
                                                    seeds, counters))))
    got = sample_tokens(*map(torch.from_numpy, (logits, temps, topks, seeds,
                                                counters)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_and_sample_is_decode_then_sample():
    """``make_decode_and_sample`` is ``decode_step`` then ``sample_tokens``
    in one call, counters advanced by one."""
    prefill, decode = port_engine.make_serve_fns(PORT_CFG, max_len=32,
                                                 kv_quant=True)
    fused = port_engine.make_decode_and_sample(PORT_CFG)
    toks = torch.randint(1, CFG.vocab_size, (2, 8),
                         generator=torch.Generator().manual_seed(0))
    lens = torch.tensor([8, 5], dtype=torch.int32)
    off = torch.tensor([0, 1000], dtype=torch.int32)
    _, cache_a = prefill(TORCH_PARAMS, toks, lens, off)
    _, cache_b = prefill(TORCH_PARAMS, toks, lens, off)
    token = torch.tensor([3, 4])
    temps = torch.tensor([0.0, 0.8])
    topks = torch.tensor([0, 40], dtype=torch.int32)
    seeds = torch.tensor([1, 2], dtype=torch.int32)
    counters = torch.tensor([7, 1007], dtype=torch.int32)
    logits, _ = decode(TORCH_PARAMS, token, cache_a, off)
    want = port_engine.sample_tokens(logits, temps, topks, seeds, counters)
    got, ctr, cache_b = fused(TORCH_PARAMS, token, cache_b, off, 0, temps,
                              topks, seeds, counters)
    assert torch.equal(got, want) and torch.equal(ctr, counters + 1)
    assert torch.equal(cache_b["pos"], lens + 1)


def test_launcher_serves_on_cpu(capsys):
    """``python -m repro_torch.launch.serve`` on the reduced model, on the
    CPU: every request finishes with its budget."""
    from repro_torch.launch.serve import serve_main

    serve_main(["--arch", "smollm_135m", "--reduced", "--device", "cpu",
                "--requests", "3", "--batch", "2", "--max-new", "3",
                "--kv-quant", "--temperature", "0.8", "--top-k", "40",
                "--sched", "priority"])
    out = capsys.readouterr().out
    assert out.count("[length]") == 3
    assert "served 3/3 requests" in out
