"""The correctness check's control and faults at a tiny size on the CPU.

The control, the reference computed in the next lower precision than the
cell states, reads a wider gap than the program on the same tokens, and
the harness's own verdict under a limit between the two readings finds
it not correct; and a run whose timed path is broken underneath comes
out not correct: a token altered where the sampler produces it, a
prefill whose cache is never merged (a step that leaves the state as it
was), and, under the dither policy, a product made without the scheme's
rounding.  The faults are held to the limits that the sound tiny runs
keep (``_bench_tiny.limits``)."""

import dataclasses
import math

import _bench_tiny
import pytest


@pytest.mark.parametrize("cell", _bench_tiny.CELLS)
def test_control_reads_wider_than_the_program(cell):
    """Three times wider on the dense cells.  The tiny MoE routes 2 of 8
    experts, so one near-tie that bf16 flips moves a logit as much as the
    control's coarser grid does: there its widest gap does not separate,
    and the control reads wider by the mean gap, the number the MoE cell
    compares (the full-width readings that set the limit are in
    PERF.md)."""
    # a window long enough that the sample holds its 40 tokens on a
    # loaded host (at 1.5 s one can finish 2 requests of 7 tokens)
    res = _bench_tiny.run_tiny(cell, seed=21, seconds=4.0, control=True)
    got, ctl = res["readings"]["program"], res["readings"]["control"]
    if "moe" not in cell:
        assert ctl["widest_gap"] > 3.0 * got["widest_gap"], res["readings"]
    assert ctl["mean_gap"] > got["mean_gap"], res["readings"]


@pytest.mark.parametrize("cell", _bench_tiny.CELLS)
def test_control_is_judged_not_correct(cell, monkeypatch):
    """The control's numbers go through the same limits as the program's:
    the run's own sample judged again under a limit between the two
    readings (the widest gap; the MoE's mean gap, as at full width) finds
    the program correct and the control not."""
    from bench import check
    seen, real = {}, check.judge

    def spy(*args):
        seen["args"] = args
        return real(*args)
    monkeypatch.setattr(check, "judge", spy)
    # a window long enough that the sample holds its 40 tokens on a
    # loaded host (at 1.5 s one can finish 2 requests of 7 tokens)
    res = _bench_tiny.run_tiny(cell, seed=21, seconds=4.0, control=True)
    name = "mean_gap" if "moe" in cell else "widest_gap"
    got, ctl = res["readings"]["program"], res["readings"]["control"]
    assert ctl[name] > got[name], res["readings"]
    params, cfg, finished, chk, seed, _, *rest = seen["args"]
    between = math.sqrt(max(got[name], 1e-6) * ctl[name])
    again = real(params, cfg, finished,
                 dict(chk, limits=dict(chk["limits"], **{name: between})),
                 seed, True, *rest)
    assert again["correct"], again["checks"]
    assert again["readings"]["control_correct"] is False, again["readings"]


def test_products_hold_to_the_scheme():
    """Every product the dither cell's timed path made after the window
    is the scheme's bit for bit; the control's 4-bit products are not."""
    res = _bench_tiny.run_tiny("granite8b-dither-chat", control=True)
    got, ctl = res["readings"]["program"], res["readings"]["control"]
    assert got["product_elements"] > 0 and got["product_mismatch"] == 0
    assert ctl["product_mismatch"] > 0.9 * ctl["product_elements"]


def _plain_product(inner):
    from repro_torch.numerics.policy import matmul

    def fused(x, w, policy, seed, counter):
        return matmul(x, w)
    return fused


def _nearest(inner):
    def fused(x, w, policy, seed, counter):
        return inner(x, w, dataclasses.replace(policy,
                                               scheme="deterministic"),
                     seed, counter)
    return fused


def _other_hash(inner):
    def fused(x, w, policy, seed, counter):
        return inner(x, w, policy, seed + 17, counter)
    return fused


@pytest.mark.parametrize("fault", [_plain_product, _nearest, _other_hash])
def test_product_without_the_schemes_rounding_is_not_correct(fault,
                                                             monkeypatch):
    """A bf16 product in the policy's place, rounding to nearest, or
    another hash: the token gaps stay within the tiny limit, but the
    products differ from the scheme's."""
    from repro_torch.numerics import policy
    monkeypatch.setattr(policy, "_fused_matmul",
                        fault(policy._fused_matmul))
    res = _bench_tiny.run_tiny("granite8b-dither-chat")
    assert not res["correct"], res["checks"]
    assert res["checks"]["product_mismatch"]["value"] > 0


def _altered(sample):
    def wrong(logits, *a, **k):
        return (sample(logits, *a, **k) + 1) % logits.shape[-1]
    return wrong


@pytest.mark.parametrize("cell", ["granite8b-dither-chat",
                                  "granitemoe-prefix-chat"])
def test_altered_token_is_not_correct(cell, monkeypatch):
    import repro_torch.serve.engine as engine
    monkeypatch.setattr(engine, "sample_tokens",
                        _altered(engine.sample_tokens))
    res = _bench_tiny.run_tiny(cell)
    assert not res["correct"], res["checks"]


def test_unmerged_prefill_is_not_correct(monkeypatch):
    from repro_torch.models import registry
    monkeypatch.setattr(registry, "merge_prefill",
                        lambda cfg, old, new, active: old)
    res = _bench_tiny.run_tiny("granite8b-bf16-long")
    assert not res["correct"], res["checks"]
