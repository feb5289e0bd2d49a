"""The system under test, and the only module of the harness that imports
it: the port's model configuration, its serving engine, and requests.

The benchmark hands the engine its own weights (``weights.py``) and
requests (``traffic.py``); it drives ``Engine.submit`` / ``Engine.step``
only, and reads ``Engine.stats``, ``Engine.tick`` and each request's host
stamps (``t_submit``, ``t_first``, ``t_last``) and its output.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

_SRC = Path(__file__).resolve().parents[1] / "src"
if str(_SRC) not in sys.path:
    sys.path.insert(0, str(_SRC))

__all__ = ["model_config", "make_engine", "make_request", "PORT_FIELDS"]

# the configuration file's "model" keys that the port's ModelConfig carries
# under the same name; the harness refuses a port config that differs
PORT_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
               "d_ff", "vocab_size", "norm_eps", "rope_theta",
               "tie_embeddings", "n_experts", "n_experts_active",
               "capacity_factor")


def model_config(conf: dict, override: dict = None):
    """The port's ``ModelConfig`` of a configuration file: its registry
    entry (``port_config``) with ``port_settings`` applied, refused where
    it differs from the file's sizes (``model``); then ``override`` (the
    CPU tests' tiny sizes) applied."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(conf["port_config"]),
                              **conf.get("port_settings", {}))
    want = conf["model"]
    diff = {k: (getattr(cfg, k), want[k]) for k in PORT_FIELDS
            if k in want and getattr(cfg, k) != want[k]}
    if diff:
        raise ValueError(f"the port's {conf['port_config']} differs from "
                         f"the benchmark's configuration: {diff}")
    return dataclasses.replace(cfg, **(override or {}))


def make_engine(params, cfg, engine: dict, device):
    """The engine of a mix's ``engine`` settings."""
    from repro_torch.numerics.policy import QuantPolicy
    from repro_torch.serve.engine import Engine

    pol = engine.get("policy")
    policy = QuantPolicy(**pol) if pol else None
    return Engine(params, cfg, batch=int(engine["slots"]),
                  max_len=int(engine["max_len"]), policy=policy,
                  kv_quant=bool(engine.get("kv_quant", False)),
                  kv_layout=engine.get("kv_layout", "ring"), device=device,
                  block_size=engine.get("block_size"),
                  prefix_cache=bool(engine.get("prefix_cache", True)),
                  decode_ticks=int(engine["decode_ticks"]))


def make_request(rid: int, prompt, max_new: int):
    """A greedy request of exactly ``max_new`` tokens: no EOS, no stops."""
    from repro_torch.serve.engine import Request
    from repro_torch.serve.sampling import SamplingParams

    return Request(rid=rid, prompt=list(prompt), max_new=int(max_new),
                   sampling=SamplingParams(temperature=0.0,
                                           max_new=int(max_new),
                                           eos_id=None, stop_ids=()))
