"""The port's data pipeline and MNIST stand-in (``repro_torch.data``)
against the reference's ``repro.data``: tokens and images bit for bit
(integer codes from the same hash; numpy draws from the same seeds)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data import mnist_like as ref_mnist
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import data_iterator as ref_iterator
from repro.data.pipeline import synthetic_batch as ref_batch
from repro_torch.configs import get_config
from repro_torch.data import mnist_like
from repro_torch.data.pipeline import (DataConfig, data_iterator,
                                       synthetic_batch)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("arch,reduced", [("smollm_135m", True),
                                          ("smollm_135m", False),
                                          ("qwen2_1_5b", True)])
@pytest.mark.parametrize("seed,step", [(0, 0), (3, 5), (7, 1234),
                                       (2 ** 31 - 1, 2 ** 20)])
def test_synthetic_batch_bitwise(arch, reduced, seed, step):
    cfg = get_config(arch)
    ref_cfg = ref_get_config(arch)
    if reduced:
        cfg, ref_cfg = cfg.reduced(), ref_cfg.reduced()
    want = ref_batch(ref_cfg, RefDataConfig(batch=3, seq=40, seed=seed),
                     step)
    got = synthetic_batch(cfg, DataConfig(batch=3, seq=40, seed=seed), step,
                          device="cpu")
    assert set(got) == {"tokens", "labels"}
    for key in got:
        assert got[key].dtype == torch.int32
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
    assert int(got["tokens"].max()) < cfg.vocab_size


def test_data_iterator_walks_the_steps():
    cfg = get_config("smollm_135m").reduced()
    ref_cfg = ref_get_config("smollm_135m").reduced()
    it = data_iterator(cfg, DataConfig(batch=2, seq=8, seed=1), start_step=4,
                       device="cpu")
    ref_it = ref_iterator(ref_cfg, RefDataConfig(batch=2, seq=8, seed=1),
                          start_step=4)
    for _ in range(3):
        np.testing.assert_array_equal(next(it)["tokens"].numpy(),
                                      np.asarray(next(ref_it)["tokens"]))


def test_stub_frontends_are_not_ported():
    """Both stub frontends are ported now: an encoder-decoder config gets
    the audio stub's ``frames`` (B, T_enc, d) bf16 beside its tokens, bit
    for bit the reference's (``tests/test_torch_encdec_train.py`` holds
    whisper's), and the VLM's ``vit_stub`` embeds
    (``tests/test_torch_zoo_train.py`` holds them against the reference)."""
    cfg = get_config("smollm_135m").reduced()
    enc = dataclasses.replace(cfg, is_encdec=True, n_enc_tokens=6)
    got = synthetic_batch(enc, DataConfig(batch=2, seq=8), 0, device="cpu")
    want = ref_batch(dataclasses.replace(ref_get_config("smollm_135m")
                                         .reduced(), is_encdec=True,
                                         n_enc_tokens=6),
                     RefDataConfig(batch=2, seq=8), 0)
    assert tuple(got["frames"].shape) == (2, 6, cfg.d_model)
    assert np.array_equal(got["frames"].view(torch.int16).numpy(),
                          np.asarray(want["frames"]).view(np.int16))
    vit = synthetic_batch(dataclasses.replace(
        cfg, frontend="vit_stub", n_frontend_tokens=4),
        DataConfig(batch=2, seq=8), 0, device="cpu")
    assert tuple(vit["embeds"].shape) == (2, 4, cfg.d_model)


@pytest.mark.parametrize("hard", [False, True])
def test_make_dataset_bitwise(hard):
    got = mnist_like.make_dataset(n_train=200, n_test=50, seed=4, hard=hard)
    want = ref_mnist.make_dataset(n_train=200, n_test=50, seed=4, hard=hard)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (200, mnist_like.IMG)
    assert mnist_like.N_CLASSES == ref_mnist.N_CLASSES == 10
    assert float(np.max(got[0])) <= 1.0 and float(np.min(got[0])) >= 0.0
