"""Serving the encoder-decoder (whisper-small at ``.reduced()``) through
the port's ``Engine(frames=...)`` against the reference's
``repro.serve.Engine`` on the same weights and frames (row i slot i's
audio): the emitted streams, decode windows, the inert ``kv_quant``, the
paths the reference refuses, restore, the static cross-KV and the
launcher.

Tolerances: the reference runs jitted as it serves, compiled as written
(``tests/_torch_zoo.py``); its logits and the port's differ by a bf16 ulp
or two (``tests/test_torch_encdec.py``: 2⁻⁸ measured), so every sampling
decision of the reference must clear twice ``LOGIT_TOL`` = 2⁻⁷
(``conftest.assert_argmax_margin``, ``tests/test_torch_zoo_serve.py``'s
check) and then the streams are equal.  A fixture that fails the check
is reseeded, never loosened.  Inside the port, windows ≡ single ticks,
``kv_quant`` ≡ bf16 and restore ≡ uninterrupted hold bit for bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve.engine as ref_engine
import repro_torch.serve.engine as port_engine
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from _torch_zoo import exact_reference_jit, model
from repro_torch.launch.serve import serve_main
from repro_torch.models import registry
from test_torch_zoo_serve import (_JITS, _SINK, LOGIT_TOL, SAMPLING,
                                  _check_decision, _requests, _sample)

ARCH = "whisper_small"
BATCH, MAX_LEN = 3, 64
# (kv_quant, decode_ticks, seed); the seeds pass the margin check
CASES = [(False, 1, 6), (True, 1, 6), (False, 4, 14), (True, 4, 14)]


def _frames(cfg, seed=0):
    """Random frames (BATCH, n_enc_tokens, d) as (jax, torch) bf16 twins."""
    f = np.random.default_rng(100 + seed).normal(
        size=(BATCH, cfg.n_enc_tokens, cfg.d_model)).astype(np.float32)
    return jnp.asarray(f, jnp.bfloat16), torch.from_numpy(f).bfloat16()


def _reference(kv_quant, ticks, seed, monkeypatch):
    """The reference engine's streams, every deciding row of its sampler
    margin-checked (``tests/test_torch_zoo_serve.py``'s ``_reference``,
    with frames)."""
    cfg, _, params, _ = model(ARCH)
    jf, _ = _frames(cfg, seed)
    _SINK.clear()
    _SINK["calls"] = calls = []
    monkeypatch.setattr(ref_engine, "sample_tokens", _sample)
    with exact_reference_jit(_JITS):
        _SINK["engine"] = eng = ref_engine.Engine(
            params, cfg, batch=BATCH, max_len=MAX_LEN, frames=jf,
            kv_quant=kv_quant, decode_ticks=ticks)
        for req in _requests(cfg, seed, ref_engine):
            eng.submit(req)
        done = sorted(eng.run(200), key=lambda r: r.rid)
    monkeypatch.undo()
    for i, ((logits, temps, topks, seeds, counters), decide) in enumerate(
            calls):
        for b in np.flatnonzero(decide):
            _check_decision(logits[b], temps[b], topks[b], seeds[b],
                            counters[b], LOGIT_TOL,
                            context=f"{ARCH} call {i} row {b}")
    assert all(len(r.out) == SAMPLING[r.rid][2] for r in done)
    return [(r.rid, r.finish_reason, r.out) for r in done]


def _engine(seed=0, **kw):
    cfg, pcfg, _, tp = model(ARCH)
    _, tf = _frames(cfg, seed)
    return port_engine.Engine(tp, pcfg, BATCH, MAX_LEN, device="cpu",
                              frames=tf, **kw)


def _port(seed=0, **kw):
    eng = _engine(seed, **kw)
    for req in _requests(eng.cfg, seed, port_engine):
        eng.submit(req)
    done = sorted(eng.run(200), key=lambda r: r.rid)
    return [(r.rid, r.finish_reason, r.out) for r in done], eng


@pytest.mark.parametrize("kv_quant,ticks,seed", CASES)
def test_engine_streams_equal_reference(kv_quant, ticks, seed, monkeypatch):
    """Greedy and sampled streams of the port's engine equal the reference
    engine's, request by request, on margin-checked fixtures: slots admit
    at different times over their own frames' cross-KV, in single ticks
    and in windows of 4."""
    want = _reference(kv_quant, ticks, seed, monkeypatch)
    got, _ = _port(seed, kv_quant=kv_quant, decode_ticks=ticks)
    assert got == want


def test_windows_equal_single_ticks_and_kv_quant_is_inert():
    """W = 4 windows give the one-tick streams bit for bit (slots
    finishing and refilled mid-window); ``kv_quant`` changes nothing (the
    self-KV is bf16, as the reference's); the cross-KV after serving is
    the one the engine built, bit for bit."""
    one, eng = _port()
    cross = {k: v.clone() for k, v in eng._make_cache()["cross"].items()}
    for k in ("k", "v"):
        assert torch.equal(eng.cache["cross"][k], cross[k])
    four, eng4 = _port(decode_ticks=4)
    assert four == one
    assert eng4.stats["decode_calls"] < eng.stats["decode_calls"]
    quant, engq = _port(kv_quant=True)
    assert quant == one
    assert engq.cache["layers"][0]["k"].dtype == torch.bfloat16


def test_slot_rows_use_their_own_frames():
    """Row i of ``frames`` is slot i's audio: the engine's cross-KV row i
    is the cache of that row alone, and the same requests served with the
    frames' rows permuted give other streams."""
    cfg, pcfg, _, tp = model(ARCH)
    _, tf = _frames(cfg)
    eng = _engine()
    for i in range(BATCH):
        alone = registry.make_cache(tp, pcfg, 1, MAX_LEN, tf[i:i + 1],
                                    device="cpu")
        for k in ("k", "v"):
            assert torch.equal(eng.cache["cross"][k][:, i],
                               alone["cross"][k][:, 0])
    want, _ = _port()
    swapped = port_engine.Engine(tp, pcfg, BATCH, MAX_LEN, device="cpu",
                                 frames=tf.flip(0).contiguous())
    for req in _requests(cfg, 0, port_engine):
        swapped.submit(req)
    got = sorted(swapped.run(200), key=lambda r: r.rid)
    assert [(r.rid, r.finish_reason, r.out) for r in got] != want


def test_paged_chunked_and_spec_are_refused():
    """The reference gives the encoder-decoder no paged cache, no chunked
    prefill and no speculative decoding: both engines raise ValueError;
    an engine without frames (or of another shape) raises too."""
    cfg, pcfg, params, tp = model(ARCH)
    jf, tf = _frames(cfg)
    assert not registry.supports_paged_kv(pcfg)
    assert not registry.supports_chunked_prefill(pcfg)
    assert not registry.supports_spec_decode(pcfg)
    for kw, match in ((dict(kv_layout="paged", block_size=8), "paged"),
                      (dict(prefill_chunk=8), "chunked prefill"),
                      (dict(spec_decode=True), "spec_decode")):
        with pytest.raises(ValueError):
            ref_engine.Engine(params, cfg, batch=BATCH, max_len=MAX_LEN,
                              frames=jf, **kw)
        with pytest.raises(ValueError, match=match):
            port_engine.Engine(tp, pcfg, BATCH, MAX_LEN, device="cpu",
                               frames=tf, **kw)
    for frames in (None, tf[:2]):
        with pytest.raises(ValueError, match="needs frames"):
            port_engine.Engine(tp, pcfg, BATCH, MAX_LEN, device="cpu",
                               frames=frames)


def test_restore_is_uninterrupted_bit_for_bit():
    """Snapshots after every step, in windows of 2: restored in place,
    the self-KV at every written position and each slot's cross-KV
    (rebuilt from the frames) equal the uninterrupted engine's byte for
    byte, and the streams finish equal."""
    def serve(eng, steps):
        for req in _requests(eng.cfg, 0, port_engine):
            req.max_new = 5 + 3 * req.rid
            eng.submit(req)
        for _ in range(steps):
            eng.step()
        return eng

    want = serve(_engine(decode_ticks=2), 200)
    want = sorted((r.rid, r.finish_reason, r.out) for r in want.finished)
    for stop in range(1, 9):
        eng = serve(_engine(decode_ticks=2), stop)
        before = eng.written_kv()
        # self k, v, k_pos and the two cross-KV rows of each slot
        assert before and all(len(p) == 5 for p in before.values())
        eng.restore(json.loads(json.dumps(eng.snapshot())))
        port_engine.Engine.compare_written_kv(before, eng.written_kv())
        eng.run(200)
        got = sorted((r.rid, r.finish_reason, r.out) for r in eng.finished)
        assert got == want, stop


def test_serve_launcher_runs(capsys):
    """``python -m repro_torch.launch.serve --arch whisper_small --reduced
    --device cpu``: zero frames, ``--kv-quant`` forced off, every request
    served."""
    serve_main(["--arch", "whisper_small", "--reduced", "--device", "cpu",
                "--requests", "3", "--batch", "2", "--max-new", "4",
                "--kv-quant", "--decode-ticks", "2"])
    out = capsys.readouterr().out
    assert out.count("[length]") == 3, out
    assert "served 3/3 requests" in out
