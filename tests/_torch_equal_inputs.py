"""The port's ``layers.rms_norm`` and ``layers.rope`` computed by the
reference's, for the tests that hold a prefill's first-layer cache to
the reference's bit for bit or within one bf16 ulp: XLA's CPU row sum in
the norm's mean and its ``exp`` in RoPE's frequencies differ from ATen's
by an f32 ulp in a way that depends on the host's vector ISA, and one
such ulp can move a bf16 norm output, then eight V elements by two bf16
ulps and their int8 codes by one (an AVX-512 host).  Under
:func:`reference_norm_and_rope` the port's layer-0 K/V are made from the
reference's inputs, so the projections, the scatter and the quantiser
are compared on equal inputs.  The tests run it only for a second
prefill whose layer-0 cache they compare; their logits come from the
port's prefill on its own ops.  Both ops are held on their own in
``tests/test_torch_model.py::test_rms_norm_and_rope``."""

import contextlib

import jax.numpy as jnp
import numpy as np
import torch

from repro.models import layers as ref_layers
from repro_torch.models import layers


@contextlib.contextmanager
def reference_norm_and_rope():
    """``layers.rms_norm`` and ``layers.rope`` of the port computed by
    the reference's, results cast back to the port's dtype."""
    def to_jax(t):
        return jnp.asarray(t.float().numpy(), jnp.dtype(str(t.dtype)[6:]))

    def back(a, like):
        return torch.from_numpy(np.asarray(a, np.float32)).to(like.dtype)

    def rms_norm(x, gamma, eps=1e-6, var=None):
        assert var is None
        return back(ref_layers.rms_norm(to_jax(x), to_jax(gamma), eps), x)

    def rope(x, positions, theta=10000.0):
        return back(ref_layers.rope(to_jax(x), jnp.asarray(positions.numpy()),
                                    theta), x)

    saved = layers.rms_norm, layers.rope
    layers.rms_norm, layers.rope = rms_norm, rope
    try:
        yield
    finally:
        layers.rms_norm, layers.rope = saved
