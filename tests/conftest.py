import os
import sys

# NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see the
# real single CPU device; only launch/dryrun.py forces 512 host devices.
_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(_ROOT, "src"))
if _ROOT not in sys.path:        # the `benchmarks` package (perf-gate tests)
    sys.path.insert(0, _ROOT)


def assert_argmax_margin(logits, axis=-1, min_margin=1e-4, context=""):
    """Assert greedy argmax over ``logits`` is decided by a real gap, not a
    float coin-flip.  Tests that pin "engine output == token-by-token
    reference" implicitly assume the top-1 logit isn't in a near-tie with
    the runner-up — otherwise a benign kernel reassociation could flip the
    argmax and the parity test would report a correctness bug that isn't
    one.  This makes that assumption explicit: it fails (loudly, with the
    gap) when a fixture drifts into a tie, telling the author to reseed the
    test rather than chase a phantom numerics regression."""
    import numpy as np

    arr = np.asarray(logits, dtype=np.float64)
    arr = np.moveaxis(arr, axis, -1).reshape(-1, arr.shape[axis])
    top2 = np.sort(arr, axis=-1)[:, -2:]
    margin = float(np.min(top2[:, 1] - top2[:, 0]))
    assert margin >= min_margin, (
        f"near-tied argmax (margin {margin:.3e} < {min_margin:.0e})"
        f"{' in ' + context if context else ''}: greedy parity checks on "
        f"these logits are numerically fragile — reseed the fixture")

try:
    from hypothesis import settings
except ModuleNotFoundError:
    # Property-based tests skip themselves via tests/_hypothesis_compat.py;
    # everything else must still collect and run (requirements-dev.txt
    # installs hypothesis for the full suite).
    pass
else:
    settings.register_profile("ci", max_examples=25, deadline=None)
    settings.load_profile("ci")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's CUDA kernels); "
        "skips where torch.cuda.is_available() is false")
