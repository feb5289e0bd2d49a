"""The port's ``Engine`` serving the MoE models (granite-moe-1b-a400m,
qwen2-moe-a2.7b) and the VLM (internvl2-1b, on tokens alone, as the
reference's engine serves it) at ``.reduced()``, against the reference's
``repro.serve.Engine`` on the same weights: ring and paged, bf16 and
int8 KV, and chunked prefill.  The emitted token streams must be equal.

The reference runs jitted as it serves, compiled as written
(``tests/_torch_zoo.py``: without XLA's excess precision its MoE router
routes as the port's does).  The two sides still sum some products in
different orders, so a bf16 logit may round the other way: over the
prefill and decode steps of ``tests/test_torch_zoo.py`` the logits of
the five configs differ from the so-compiled reference's by at most
0.0059 (one or two bf16 ulps; 0 for three of them).  ``LOGIT_TOL`` =
2⁻⁷ covers that, and every sampling decision of the reference must clear
twice it (``conftest.assert_argmax_margin``, as
``tests/test_torch_serve.py`` checks it); a fixture that fails the check
is reseeded, never loosened.

MoE couples the rows of a call: capacity ranks are a cumulative count
over every token of the call, padding and idle rows included.  So the
port prefills each admission wave in one call at the longest prompt's
bucket, as the reference does, and keeps all slots, idle ones too, in
every decode tick.  For the same reason an MoE engine restores as the
reference's does, held to the reference's restore from one snapshot.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import assert_argmax_margin

import repro.serve.engine as ref_engine
import repro_torch.serve.engine as port_engine
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_zoo import exact_reference_jit, model
from repro.core import rounding as ref_rounding

LOGIT_TOL = 2.0 ** -7
BATCH, MAX_LEN, BLOCK = 3, 64, 8
# (temperature, top_k, max_new) by rid: greedy and sampled, budgets that
# free slots mid-run so the last request joins running ones
SAMPLING = [(0.0, 0, 2), (0.8, 0, 3), (0.8, 40, 4), (1.0, 0, 2)]
# (arch, layout, kv_quant, prefill_chunk, decode_ticks, seed); the seeds
# pass the margin check
CASES = [
    ("granite_moe_1b_a400m", "ring", False, None, 1, 4),
    ("granite_moe_1b_a400m", "ring", True, None, 1, 10),
    ("granite_moe_1b_a400m", "paged", False, None, 1, 4),
    ("granite_moe_1b_a400m", "paged", True, None, 1, 4),
    ("granite_moe_1b_a400m", "ring", True, 8, 1, 11),
    ("granite_moe_1b_a400m", "ring", True, None, 4, 5),
    ("qwen2_moe_a2_7b", "ring", False, None, 1, 5),
    ("qwen2_moe_a2_7b", "paged", True, None, 1, 1),
    ("qwen2_moe_a2_7b", "paged", True, 8, 1, 14),
    ("qwen2_moe_a2_7b", "paged", False, None, 4, 19),
    ("qwen2_moe_a2_7b", "paged+prefix", True, None, 1, 4),
    ("granite_moe_1b_a400m", "paged+prefix", False, None, 1, 2),
    ("internvl2_1b", "ring", True, None, 1, 1),
    ("internvl2_1b", "paged", False, None, 1, 3),
    ("internvl2_1b", "ring", False, 8, 1, 3),
]


def _requests(cfg, seed, mod, prefix=0):
    """One request per ``SAMPLING`` row, prompts of 3..20 tokens after a
    shared system prompt of ``prefix`` tokens."""
    rng = np.random.default_rng(seed)
    system = rng.integers(1, cfg.vocab_size, size=prefix).tolist()
    reqs = []
    for r, (temp, top_k, max_new) in enumerate(SAMPLING):
        prompt = system + rng.integers(1, cfg.vocab_size,
                                       size=int(rng.integers(3, 21))).tolist()
        # a shared prefix is reused only under one counter offset (the
        # int8 codes' hash chain starts from it)
        sp = mod.SamplingParams(temperature=temp, top_k=top_k, seed=seed + r,
                                max_new=max_new,
                                counter_offset=0 if prefix else 1000 * r)
        reqs.append(mod.Request(rid=r, prompt=prompt, sampling=sp))
    return reqs


def _check_decision(logits, temp, top_k, seed, counter, tol, context):
    """One row's sampling decision survives a logit error of ``tol``
    (``tests/test_torch_serve.py``'s check): greedy, the top-2 gap exceeds
    2·tol; sampled, the deciding scores over the widest top-k set the
    error allows lead by 2·tol / T, and the winner is inside every such
    set."""
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
    assert rivals < k, (f"sampled {context}: the winner sits on the top-k "
                        "boundary — reseed the fixture")


def _knobs(layout, kv_quant, chunk, ticks=1):
    """Engine knobs of a case; layout ``"paged+prefix"`` is the paged
    layout on traffic with a shared system prompt (``_traffic``)."""
    kw = dict(kv_quant=kv_quant, kv_layout=layout.split("+")[0],
              prefill_chunk=chunk, decode_ticks=ticks)
    if kw["kv_layout"] == "paged":
        kw["block_size"] = BLOCK
    return kw


def _traffic(cfg, layout, seed, mod):
    """A case's requests: with a 16-token (two-block) system prompt for
    ``"paged+prefix"``, so requests admitted after the first wave hit the
    prefix cache."""
    return _requests(cfg, seed, mod, prefix=2 * BLOCK
                     if layout.endswith("+prefix") else 0)


_REF_SAMPLE = ref_engine.sample_tokens
_SINK = {}   # the running reference engine and its sampler's calls
_JITS = {}   # the reference engines' jits, shared (exact_reference_jit)


def _record(*arrays):
    """Log a sampler call of the running reference engine with the rows
    that decide: rows of a prefill call whose request has no token yet,
    else every occupied slot."""
    slots = _SINK["engine"].slots
    fresh = any(s is not None and not s.out
                and getattr(s, "state", "active") != "prefilling"
                for s in slots)
    decide = [s is not None and (not s.out if fresh else True)
              for s in slots]
    _SINK["calls"].append(([np.array(a) for a in arrays], decide))


def _sample(*args):
    jax.debug.callback(_record, *args)
    return _REF_SAMPLE(*args)


def _reference(arch, layout, kv_quant, chunk, ticks, seed, monkeypatch):
    """The reference engine's streams, every deciding row of its sampler
    margin-checked.  Its sampler is patched by one module-level function
    for every case, so the traces its jits share log to this case's
    sink."""
    cfg, _, params, _ = model(arch)
    _SINK.clear()
    _SINK["calls"] = calls = []
    monkeypatch.setattr(ref_engine, "sample_tokens", _sample)
    with exact_reference_jit(_JITS):
        _SINK["engine"] = eng = ref_engine.Engine(
            params, cfg, batch=BATCH, max_len=MAX_LEN,
            **_knobs(layout, kv_quant, chunk, ticks))
        for req in _traffic(cfg, layout, seed, ref_engine):
            eng.submit(req)
        done = sorted(eng.run(200), key=lambda r: r.rid)
    monkeypatch.undo()
    if layout.endswith("+prefix"):
        assert eng.stats["prefix_hit_tokens"] > 0
    emitted = {r.rid: list(r.out) for r in done}
    for i, ((logits, temps, topks, seeds, counters), decide) in enumerate(
            calls):
        for b in np.flatnonzero(decide):
            _check_decision(logits[b], temps[b], topks[b], seeds[b],
                            counters[b], LOGIT_TOL,
                            context=f"{arch} call {i} row {b}")
    assert all(len(emitted[r]) == SAMPLING[r][2] for r in emitted)
    return [(r.rid, r.finish_reason, r.out) for r in done]


def _port(arch, layout, kv_quant, chunk, ticks, seed, reqs=None):
    _, pcfg, _, tp = model(arch)
    eng = port_engine.Engine(tp, pcfg, BATCH, MAX_LEN, device="cpu",
                             **_knobs(layout, kv_quant, chunk, ticks))
    for req in reqs or _traffic(pcfg, layout, seed, port_engine):
        eng.submit(req)
    done = sorted(eng.run(200), key=lambda r: r.rid)
    return [(r.rid, r.finish_reason, r.out) for r in done], eng


@pytest.mark.parametrize("arch,layout,kv_quant,chunk,ticks,seed", CASES)
def test_engine_streams_equal_reference(arch, layout, kv_quant, chunk, ticks,
                                        seed, monkeypatch):
    """Greedy and sampled streams of the port's engine equal the reference
    engine's, request by request, on margin-checked fixtures, also in
    windows of 4 ticks.  For MoE a window's streams may differ from single
    ticks' in both packages (``test_moe_windows_equal_single_ticks``), so
    each layout is held to the reference at the same window."""
    ref = _reference(arch, layout, kv_quant, chunk, ticks, seed, monkeypatch)
    port, eng = _port(arch, layout, kv_quant, chunk, ticks, seed)
    if layout.endswith("+prefix"):   # MoE prefix hits: ROADMAP "Findings"
        assert eng.stats["prefix_hit_tokens"] > 0
    assert port == ref
    assert all(reason == "length" and len(out) == SAMPLING[rid][2]
               for rid, reason, out in port)


@pytest.mark.parametrize("arch,calls", [("granite_moe_1b_a400m", 1),
                                        ("granite_3_8b", 2)])
def test_moe_prefill_is_one_call_per_wave(arch, calls, monkeypatch):
    """A wave of prompts in two length buckets (3 and 20 tokens): the MoE
    model prefills it in one call of (batch, bucket of the longest
    prompt), idle rows included, as the reference does — its capacity
    ranks count every token of the call, so a call per bucket would change
    which assignments drop.  A dense model keeps the port's call per
    bucket."""
    _, pcfg, _, tp = model(arch)
    eng = port_engine.Engine(tp, pcfg, BATCH, MAX_LEN, device="cpu")
    shapes = []
    inner = eng._prefill

    def spy(params, tokens, *args, **kw):
        shapes.append(tuple(tokens.shape))
        return inner(params, tokens, *args, **kw)

    monkeypatch.setattr(eng, "_prefill", spy)
    rng = np.random.default_rng(0)
    for r, n in enumerate((3, 20)):
        eng.submit(port_engine.Request(
            rid=r, prompt=rng.integers(1, pcfg.vocab_size, size=n).tolist(),
            max_new=1))
    eng.step()
    assert len(shapes) == calls
    assert shapes[-1] == (BATCH, 32)
    if calls == 1:
        assert eng.stats["prefill_calls"] == 1


@pytest.mark.parametrize("arch,layout,kv_quant", [
    ("granite_moe_1b_a400m", "ring", True),
    ("qwen2_moe_a2_7b", "paged", False)])
def test_moe_windows_equal_single_ticks(arch, layout, kv_quant):
    """W = 4 decode windows give the one-tick streams while no slot changes
    mid-window: one wave of B requests with budgets of 8 tokens, so every
    tick's MoE call sees the same rows either way.  (When a slot finishes
    mid-window, single ticks admit the next request at once and a window
    only after it ends; the ticks' calls then hold other tokens, capacity
    ranks differ, and the streams may differ — in the reference's engine
    too, ROADMAP "Findings".)"""
    _, pcfg, _, _ = model(arch)
    rng = np.random.default_rng(6)

    def reqs():
        return [port_engine.Request(
            rid=r, prompt=rng.integers(1, pcfg.vocab_size, size=n).tolist(),
            sampling=port_engine.SamplingParams(
                temperature=0.8 * (r % 2), seed=r, max_new=8,
                counter_offset=1000 * r))
            for r, n in enumerate((5, 17, 11))]

    state = rng.bit_generator.state
    one, _ = _port(arch, layout, kv_quant, None, 1, 0, reqs())
    rng.bit_generator.state = state
    four, eng = _port(arch, layout, kv_quant, None, 4, 0, reqs())
    assert four == one
    assert eng.stats["decode_calls"] == 2 and eng.tick == 8


# (arch, layout, kv_quant, seed); the seeds pass the margin check
RESTORE_CASES = [("granite_moe_1b_a400m", "ring", False, 0),
                 ("qwen2_moe_a2_7b", "ring", True, 5),
                 ("granite_moe_1b_a400m", "paged", True, 10)]


@pytest.mark.parametrize("arch,layout,kv_quant,seed", RESTORE_CASES)
def test_moe_restore_is_the_reference_restore(arch, layout, kv_quant, seed,
                                              monkeypatch, tmp_path):
    """An MoE engine snapshots (``snapshot_path``) and restores as the
    reference's engine does: one prefill call over every occupied row,
    then a decode replay with the rows out of tokens inert at token 0.
    From one snapshot of the port's, written mid-flight with slots at
    unequal lengths, the port's and the reference's restores rebuild the
    occupied slots' KV within the logit tolerance 2⁻⁶ (int8: three code
    steps, ``_written``), and both engines finish with equal streams,
    every decision of the reference's margin-checked.  (Neither is the uninterrupted run:
    capacity ranks count every token of a call, ROADMAP Findings.)"""
    _, pcfg, _, tp = model(arch)
    path = str(tmp_path / "snap.json")
    eng = port_engine.Engine(tp, pcfg, BATCH, MAX_LEN, device="cpu",
                             snapshot_path=path,
                             **_knobs(layout, kv_quant, None))
    for req in _restore_requests(pcfg, seed):
        eng.submit(req)
    for _ in range(3):
        eng.step()
    assert len({len(r.out) for r in eng.slots if r is not None}) > 1
    with open(path) as fh:
        snap = json.load(fh)

    port = port_engine.Engine(tp, pcfg, BATCH, MAX_LEN, device="cpu",
                              **_knobs(layout, kv_quant, None))
    port.restore(snap)
    assert port.last_restore["prefill_calls"] == 1
    got = _hold_to_reference_restore(arch, layout, snap, port,
                                     _knobs(layout, kv_quant, None),
                                     monkeypatch)
    assert [len(r.out) for r in got] == list(RESTORE_BUDGETS)


# (arch, kv_quant, seed); the seeds preempt a request with its blocks
# in a pool of PREEMPT_BLOCKS blocks of 4 tokens and pass the margin check
PREEMPT_CASES = [("granite_moe_1b_a400m", False, 1),
                 ("qwen2_moe_a2_7b", True, 0)]
PREEMPT_BLOCKS = 12


@pytest.mark.parametrize("arch,kv_quant,seed", PREEMPT_CASES)
def test_moe_restore_reprefills_queued_block_holders(arch, kv_quant, seed,
                                                     monkeypatch):
    """Under pool pressure a paged MoE engine preempts a request and
    queues it with its blocks.  An MoE restore rebuilds the slots alone,
    so such a request has no KV to resume on (the reference resumes it on
    zeroed blocks): the port's restore gives its blocks back and it
    re-prefills its history when admitted again.  From one snapshot with
    a queued block holder, the port's restore is the reference's restore
    followed by that release (``_release_for_reprefill``): the slots'
    KV within ``_written``'s bounds and equal streams, every decision of
    the reference's margin-checked, every budget completed."""
    _, pcfg, _, tp = model(arch)
    kw = dict(_knobs("paged", kv_quant, None), block_size=4,
              num_blocks=PREEMPT_BLOCKS, prefix_cache=False)
    eng = port_engine.Engine(tp, pcfg, BATCH, MAX_LEN, device="cpu", **kw)
    for req in _restore_requests(pcfg, seed):
        eng.submit(req)
    held = []
    while not held:
        eng.step()
        held = [r.rid for r in eng.scheduler.queued()
                if r._resume is not None and not r._resume.get("reprefill")
                and eng.pool.table(r.rid)]
        assert eng.tick < 30, "the fixture must preempt a request"
    snap = json.loads(json.dumps(eng.snapshot()))

    port = port_engine.Engine(tp, pcfg, BATCH, MAX_LEN, device="cpu", **kw)
    port.restore(snap)
    for req in port.scheduler.queued():
        if req.rid in held:
            assert req._resume["reprefill"] and not port.pool.table(req.rid)
    got = _hold_to_reference_restore(arch, "paged", snap, port, kw,
                                     monkeypatch, release=held)
    assert [len(r.out) for r in got] == list(RESTORE_BUDGETS)


def _hold_to_reference_restore(arch, layout, snap, port, knobs, monkeypatch,
                               release=()):
    """Restore ``snap`` into the reference's engine of engine knobs
    ``knobs`` (then release the queued requests ``release`` for
    re-prefill), compare the occupied slots' KV with the restored
    ``port``'s, and run both to the end: equal streams, every sampling
    decision of the reference's margin-checked.  Returns the port's
    finished requests by rid."""
    cfg, _, params, _ = model(arch)
    _SINK.clear()
    _SINK["calls"] = calls = []
    monkeypatch.setattr(ref_engine, "sample_tokens", _sample)
    with exact_reference_jit(_JITS):
        _SINK["engine"] = ref = ref_engine.Engine(
            params, cfg, batch=BATCH, max_len=MAX_LEN, **knobs)
        ref.restore(json.loads(json.dumps(snap)))
        for req in ref.scheduler.queued():
            if req.rid in release:
                ref._release_for_reprefill(req)
        for i, req in enumerate(port.slots):
            if req is None:
                continue
            for got, want in zip(_written(port.cache, layout, port, i, req),
                                 _written(ref.cache, layout, ref, i, req)):
                assert np.all(np.abs(got[0] - want[0])
                              <= np.maximum(got[1], want[1])), i
        done = sorted(ref.run(200), key=lambda r: r.rid)
    monkeypatch.undo()
    for i, ((logits, temps, topks, seeds, counters), decide) in enumerate(
            calls):
        for b in np.flatnonzero(decide):
            _check_decision(logits[b], temps[b], topks[b], seeds[b],
                            counters[b], LOGIT_TOL,
                            context=f"{arch} call {i} row {b}")
    got = sorted(port.run(200), key=lambda r: r.rid)
    assert [(r.rid, r.out) for r in got] == [(r.rid, r.out) for r in done]
    return got


RESTORE_BUDGETS = (6, 3, 8, 5)


def _restore_requests(cfg, seed):
    """``_requests`` with the budgets ``RESTORE_BUDGETS``: after three
    steps the slots hold requests admitted in different waves."""
    reqs = _requests(cfg, seed, port_engine)
    for req, n in zip(reqs, RESTORE_BUDGETS):
        req.sampling = dataclasses.replace(req.sampling, max_new=n)
    return reqs


def _written(cache, layout, eng, i, req):
    """Slot i's written positions of every attention layer of a cache (the
    port's or the reference's): per K and V, the values (int8 codes
    dequantised, code × scale / 127) and the bound a restore is held to:
    2⁻⁶ for bf16; for int8 three code steps, 3 × scale / 127: an ulp of
    the bf16 K/V before the quantiser moves the row's absmax scale by an
    ulp, which shifts every scaled value, and the dither rounding of a
    value by a code either way (measured: at most 2.04 code steps, in 8
    to 22 of 2,688 to 5,376 values, at the seeds searched)."""
    def arr(t):
        if isinstance(t, torch.Tensor):
            return t.float().numpy()
        return np.asarray(t.astype(jnp.float32))

    w = int(eng._slot_pos[i])
    out = []
    for stacked, entries in ((True, cache["layers"]),
                             (False, cache["remainder"])):
        for entry in entries:
            rows = {}
            for name, t in entry.items():
                t = arr(t) if stacked else arr(t)[None]
                if layout == "paged":
                    pool = eng.pool if hasattr(eng, "pool") else eng.pools[0]
                    blocks = pool.table(req.rid)[:-(-w // pool.block_size)]
                    rows[name] = t[:, blocks].reshape(
                        (t.shape[0], -1) + t.shape[3:])[:, :w]
                else:
                    cap = t.shape[2]
                    rows[name] = t[:, i, [p % cap for p in range(
                        max(0, w - cap), w)]]
            for name in ("k", "v"):
                if f"{name}_scale" in rows:
                    scale = rows[f"{name}_scale"][..., None]
                    out.append((rows[name] * scale / 127.0,
                                3.0 * scale / 127.0))
                else:
                    out.append((rows[name], np.full_like(rows[name],
                                                         2.0 ** -6)))
    return out
