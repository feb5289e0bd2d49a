"""Shared fixtures of the zoo tests (``tests/test_torch_zoo*.py``,
``tests/test_torch_moe.py``): one model per architecture at
``.reduced()`` in both packages, and the reference compiled as written.

The reference's jit lets XLA keep excess precision through bf16
intermediates (``xla_allow_excess_precision``, on by default): a fused
``rms_norm`` feeds the MoE router unrounded values, and its f32 logits
move by up to 1.7e-3 (measured at the reduced configs).  A near-tied
top-k then picks another expert, which moves a token's logits by as much
as 0.27; at these sizes nearly every call has such a tie.  Compiled with
that option off (``EXACT``), every bf16 op rounds as written, the
reference's router logits equal its op-by-op values bit for bit, and so
do the port's.  ``ref_jit`` and ``exact_reference_jit`` compile the
reference so.

The weights are drawn by the port's own init (a ``torch.Generator``, no
JAX compile) and carried to the reference bit for bit, bf16 through an
int16 view; ``tests/test_torch_zoo.py`` checks that the reference's own
init has the same tree.  The QKV biases, zeros at init, are drawn at
random so that the bias path is exercised.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.models import registry

ZOO = ["granite_3_8b", "minicpm_2b", "internvl2_1b", "granite_moe_1b_a400m",
       "qwen2_moe_a2_7b"]
MOE = ["granite_moe_1b_a400m", "qwen2_moe_a2_7b"]
EXACT = {"xla_allow_excess_precision": False}
_MODELS = {}


def to_jax(t: torch.Tensor):
    """A CPU tensor → a JAX array, bit for bit (bf16 through int16)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def model(arch):
    """(reference config, port config, reference params, port params) at
    ``.reduced()``, built once per process from the port's init (seed 0)
    with random QKV biases."""
    if arch not in _MODELS:
        pcfg = get_config(arch).reduced()
        tp = registry.init_model(pcfg, seed=0, device="cpu")
        if pcfg.qkv_bias:
            gen = torch.Generator().manual_seed(7)
            attn = tp["blocks"][0]["attn"]
            for name in ("bq", "bk", "bv"):
                attn[name] = (torch.randn(attn[name].shape, generator=gen)
                              * 0.5).bfloat16()
        flat = [to_jax(leaf) for leaf in tree.leaves(tp)]
        params = tree.unflatten(tp, flat)
        _MODELS[arch] = (ref_get_config(arch).reduced(), pcfg, params, tp)
    return _MODELS[arch]


def embeds(cfg, b, seed=0):
    """Random stub-frontend embeddings (B, F, d) for a ``vit_stub`` config,
    else None: (jax, torch) twins."""
    if cfg.frontend != "vit_stub":
        return None, None
    e = np.random.default_rng(seed).normal(
        size=(b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return jnp.asarray(e, jnp.bfloat16), torch.from_numpy(e).bfloat16()


def ref_jit(fn, static_argnums=(1,), static_argnames=()):
    """``jax.jit`` of a reference function, compiled as written
    (``EXACT``); by default its second argument, the config, is static."""
    return jax.jit(fn, static_argnums=static_argnums,
                   static_argnames=static_argnames, compiler_options=EXACT)


def _jit_key(fun, args, kw):
    """A key under which two ``jax.jit`` calls compile the same function:
    the code, closure values, defaults and partial arguments of ``fun``
    and the jit options, all hashable; else None (not shared)."""
    parts = []
    while isinstance(fun, functools.partial):
        parts.append((fun.args, tuple(sorted(fun.keywords.items()))))
        fun = fun.func
    code = getattr(fun, "__code__", None)
    if code is None:
        return None
    cells = tuple(c.cell_contents for c in fun.__closure__ or ())
    opts = tuple(sorted((k, tuple(sorted(v.items())) if isinstance(v, dict)
                         else v) for k, v in kw.items()))
    key = (code, cells, fun.__defaults__, tuple(parts), args, opts)
    try:
        hash(key)
    except TypeError:
        return None
    return key


@contextlib.contextmanager
def exact_reference_jit(shared=None):
    """Every ``jax.jit`` made inside (the reference engine's steps) is
    compiled as written (``EXACT``).  The reference engine jits fresh
    closures per engine; given a dict ``shared``, a closure whose code and
    closure values an earlier call with that dict jitted reuses that jit
    and its compilations.  A trace also reads module globals, which the
    key does not hold, so a caller shares a dict only between engines made
    under the same globals (the same patched sampler)."""
    orig = jax.jit

    def jit(fun=None, *args, **kw):
        kw.setdefault("compiler_options", EXACT)
        key = None
        if shared is not None and fun is not None:
            key = _jit_key(fun, args, kw)
        if key is None:
            return orig(fun, *args, **kw)
        if key not in shared:
            shared[key] = orig(fun, *args, **kw)
        return shared[key]

    jax.jit = jit
    try:
        yield
    finally:
        jax.jit = orig
