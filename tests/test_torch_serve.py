"""The port's serving slice as a whole against the JAX package: one run
directory and one JAX-fitted GBT head, scored by both ``Scorer``s.

Tolerances: latents 2e-5, reconstruction 1e-4 (the decoder runs 320 steps
of three LSTMs after the latent), probability 1e-5.
"""

import os

import jax
import numpy as np
import pytest
import torch

from ae_waveforms_tpu.classify.gbt import GBTClassifier as JaxGBTClassifier
from ae_waveforms_tpu.core.config import TrainConfig as JaxTrainConfig
from ae_waveforms_tpu.models import lstm_ae
from ae_waveforms_tpu.serve import Scorer as JaxScorer
from ae_waveforms_tpu.train.checkpoint import save_state
from ae_waveforms_tpu_torch.bridge import gbt_from_numpy
from ae_waveforms_tpu_torch.core.config import TrainConfig
from ae_waveforms_tpu_torch.serve import Scorer

RUN = "run-0"


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    results = str(tmp_path_factory.mktemp("results"))
    save_state(os.path.join(results, "networks_autoencoder", RUN, "model_autoencoder.npz"),
               lstm_ae.init(jax.random.PRNGKey(0), 10))
    rng = np.random.default_rng(0)
    waves = rng.standard_normal((5, 320)).astype(np.float32)
    jscorer = JaxScorer.from_run(results, RUN, JaxTrainConfig())
    scorer = Scorer.from_run(results, RUN, TrainConfig(), device="cpu")
    # the head is fitted on other latent-shaped data, so no scored latent
    # sits on a bin edge (a float-rounding flip there changes the leaf)
    z = jscorer.score(waves, bucket=8)["latents"]
    X = (z.mean(0) + z.std(0) * rng.standard_normal((200, z.shape[1]))).astype(np.float32)
    y = (X[:, 0] > np.median(X[:, 0])).astype(np.float32)
    jgbt = JaxGBTClassifier(max_depth=3, n_estimators=10, random_state=0).fit(X, y)
    e = jgbt._ens
    gbt = gbt_from_numpy(e.feat, e.thresh, e.is_split, e.leaf, e.lr, jgbt._edges, jgbt.get_params(),
                         device="cpu")
    out_j = jscorer.attach_gbt(jgbt).score(waves, bucket=8)
    out_t = scorer.attach_gbt(gbt).score(waves, bucket=8)
    return out_j, out_t


def test_scorer_keys_shapes_dtypes_match_jax(scored):
    out_j, out_t = scored
    assert sorted(out_t) == sorted(out_j) == ["latents", "prd", "probability", "reconstruction", "rmse"]
    for k in out_j:
        assert out_t[k].shape == out_j[k].shape, k
        assert out_t[k].dtype == out_j[k].dtype, k
    assert out_t["reconstruction"].shape == (5, 320) and out_t["latents"].shape == (5, 10)


@pytest.mark.parametrize("key,atol", [("latents", 2e-5), ("reconstruction", 1e-4), ("rmse", 1e-4),
                                      ("prd", 1e-3), ("probability", 1e-5)])
def test_scorer_matches_jax(scored, key, atol):
    out_j, out_t = scored
    assert np.all(np.isfinite(out_t[key]))
    np.testing.assert_allclose(out_t[key], out_j[key], atol=atol, rtol=0)


def test_scorer_bucketing_consistent():
    model_cfg = TrainConfig()
    from ae_waveforms_tpu_torch.models.registry import model_def

    model = model_def(model_cfg.model_class).build(4, hidden_sizes=(8, 6),
                                                   generator=torch.Generator().manual_seed(1), device="cpu")
    scorer = Scorer(model, model_cfg.model_class, device="cpu")
    w = np.random.default_rng(1).standard_normal((20, 40)).astype(np.float32)
    a = scorer.score(w[:5], bucket=16)
    b = scorer.score(w, bucket=16)
    assert a["latents"].shape == (5, 4) and b["latents"].shape == (20, 4)
    np.testing.assert_allclose(a["latents"], b["latents"][:5], atol=1e-6)


@pytest.mark.parametrize("matmul,cudnn", [(True, True), (False, False), (True, False)])
def test_decoder_and_scorer_keep_the_tf32_flags(matmul, cudnn):
    """The decoder keeps its cuDNN LSTMs out of TF32 inside a scoped switch:
    building a Scorer and scoring leave the process's TF32 flags as they
    were."""
    from ae_waveforms_tpu_torch.models.registry import model_def

    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = [f.allow_tf32 for f in flags]
    try:
        for f, v in zip(flags, (matmul, cudnn)):
            f.allow_tf32 = v
        cfg = TrainConfig()
        model = model_def(cfg.model_class).build(4, hidden_sizes=(8, 6), generator=torch.Generator().manual_seed(2),
                                                 device="cpu")
        scorer = Scorer(model, cfg.model_class, device="cpu")
        assert [f.allow_tf32 for f in flags] == [matmul, cudnn]
        out = scorer.score(np.random.default_rng(2).standard_normal((3, 40)).astype(np.float32), bucket=4)
        assert np.all(np.isfinite(out["reconstruction"]))
        assert [f.allow_tf32 for f in flags] == [matmul, cudnn]
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v
