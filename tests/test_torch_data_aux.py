"""The port's dataset view, model registry, sub-package exports and MIMIC
adapter against the JAX package's, on numpy-seeded inputs (CPU)."""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ae_waveforms_tpu.classify as jax_classify
import ae_waveforms_tpu.core as jax_core
import ae_waveforms_tpu.models as jax_models
import ae_waveforms_tpu.train as jax_train
import ae_waveforms_tpu_torch.classify as torch_classify
import ae_waveforms_tpu_torch.core as torch_core
import ae_waveforms_tpu_torch.models as torch_models
import ae_waveforms_tpu_torch.train as torch_train
from ae_waveforms_tpu.core.config import ExtractionConfig as JaxExtractionConfig
from ae_waveforms_tpu.data import mimic_io as jax_mimic
from ae_waveforms_tpu.data.extract import extract_cases as jax_extract_cases
from ae_waveforms_tpu.models import registry as jax_registry
from ae_waveforms_tpu.train.data import WaveDataset as JaxWaveDataset
from ae_waveforms_tpu_torch.bridge import tree_from_numpy
from ae_waveforms_tpu_torch.core.config import ExtractionConfig
from ae_waveforms_tpu_torch.data import mimic_io
from ae_waveforms_tpu_torch.data.extract import extract_cases
from ae_waveforms_tpu_torch.models import registry
from ae_waveforms_tpu_torch.train.data import WaveDataset

MODELS = ("LSTMAutoencoder", "LeNet5AutoencoderAvgPool")


def dataset_inputs(n=12, seed=0):
    rng = np.random.default_rng(seed)
    waves = rng.standard_normal((n, 320)).astype(np.float32)
    feats = rng.standard_normal((n, 35))
    info = np.stack([np.repeat([3, 1, 2], n // 3), np.arange(n) * 10000], axis=1).astype(float)
    return waves, feats, info


@pytest.mark.parametrize("channel_first", [True, False])
@pytest.mark.parametrize("with_flag", [True, False])
def test_wave_dataset_matches_jax(channel_first, with_flag):
    waves, feats, info = dataset_inputs()
    flag = info[:, 0] != 2 if with_flag else None
    ds = WaveDataset(waves, feats, info, flag=flag, channel_first=channel_first)
    ref = JaxWaveDataset(waves, feats, info, flag=flag, channel_first=channel_first)
    assert isinstance(ds, torch.utils.data.Dataset)
    assert len(ds) == len(ref) == (8 if with_flag else 12)
    for i in range(len(ds)):
        for got, want in zip(ds[i], ref[i]):
            assert type(got) is type(want) and got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    assert ds[0][0].shape == ((1, 320) if channel_first else (320, 1))
    np.testing.assert_array_equal(ds.get_yvals(), ref.get_yvals())
    # a DataLoader collates the numpy rows into tensors, in order
    x, y, f, c = next(iter(torch.utils.data.DataLoader(ds, batch_size=5)))
    np.testing.assert_array_equal(x.numpy(), ds.wave[:5])
    np.testing.assert_array_equal(c.numpy(), ds.info[:5])


def test_patient_demographics_match_jax():
    pytest.importorskip("pandas")
    waves, feats, info = dataset_inputs(seed=1)
    got = WaveDataset(waves, feats, info).get_patient_demographics()
    want = JaxWaveDataset(waves, feats, info).get_patient_demographics()
    assert list(got.columns) == list(want.columns) and list(got["id"]) == [1.0, 2.0, 3.0]
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())


@pytest.mark.parametrize("name", MODELS)
def test_build_model_and_bridge_give_the_jax_forward(name):
    jax_def, params = jax_registry.build_model(name, jax.random.PRNGKey(3), 6)
    mdef, model = registry.build_model(name, generator=torch.Generator().manual_seed(3), latent_size=6,
                                       device="cpu")
    assert isinstance(model, mdef.build) and mdef.name == jax_def.name == name
    assert mdef.channel_first == jax_def.channel_first
    model.load_jax_tree(tree_from_numpy(jax.tree.map(np.asarray, params), device="cpu"))
    model.eval()
    waves = np.random.default_rng(4).standard_normal((3, 320)).astype(np.float32)
    x = waves[:, None, :] if registry.input_layout(name) else waves[:, :, None]
    want = np.asarray(jax.jit(jax_def.forward)(params, jnp.asarray(x)))  # one compile, not one an op
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_registry_layouts_and_unknown_names():
    for name in MODELS:
        assert registry.input_layout(name) == jax_registry.input_layout(name)
    assert registry.input_layout("LeNet5AutoencoderAvgPool") and not registry.input_layout("LSTMAutoencoder")
    with pytest.raises(ValueError, match="unknown model class 'Nope'") as mine:
        registry.build_model("Nope", device="cpu")
    with pytest.raises(ValueError, match="unknown model class 'Nope'") as theirs:
        jax_registry.build_model("Nope", jax.random.PRNGKey(0), 6)
    assert str(mine.value) == str(theirs.value)
    for layout in (registry.input_layout, jax_registry.input_layout):
        with pytest.raises(KeyError):
            layout("Nope")


@pytest.mark.parametrize("jax_pkg, torch_pkg", [(jax_core, torch_core), (jax_classify, torch_classify),
                                                (jax_models, torch_models), (jax_train, torch_train)])
def test_sub_packages_re_export_the_jax_names(jax_pkg, torch_pkg):
    want = ["Ranger" if n == "ranger" else n for n in jax_pkg.__all__]
    assert torch_pkg.__all__ == want
    for n in want:
        assert getattr(torch_pkg, n) is not None
    assert issubclass(torch_train.Ranger, torch.optim.Optimizer)
    assert torch_models.build_model is registry.build_model


def test_mimic_gate_raises_without_wfdb(monkeypatch):
    monkeypatch.setitem(sys.modules, "wfdb", None)  # import wfdb raises ImportError
    for mod in (mimic_io, jax_mimic):
        assert not mod.have_wfdb()
        with pytest.raises(RuntimeError, match="wfdb client not available"):
            mod.make_mimic_loader(["rec"])


def stub_wfdb(records):
    """A stand-in ``wfdb`` whose rdrecord serves ``records`` (path ->
    (fs, lead names, (T, leads) signal))."""
    def rdrecord(path):
        fs, names, sig = records[path]
        return types.SimpleNamespace(fs=fs, sig_name=list(names), p_signal=sig)

    return types.SimpleNamespace(rdrecord=rdrecord)


LEADS = ("I", "II", "III", "aVR", "aVL", "aVF", "V1", "V2", "V3", "V4", "V5", "V6")


def mimic_records(seconds=10.0):
    rng = np.random.default_rng(5)
    records = {f"r{fs}": (fs, LEADS, rng.standard_normal((int(seconds * fs), 12))) for fs in (250, 500, 1000)}
    nan = rng.standard_normal((5000, 12))
    nan[:, 1] = np.nan
    records["nan"] = (500, LEADS, nan)
    records["no_ii"] = (500, ("I", "III"), rng.standard_normal((5000, 2)))
    return records


@pytest.mark.parametrize("path, lead, target_fs", [
    ("r250", "II", 500), ("r500", "II", 500), ("r1000", "II", 500), ("r1000", "v5", 250),
    ("nan", "II", 500), ("no_ii", "II", 500),
])
def test_load_mimic_record_matches_jax(monkeypatch, path, lead, target_fs):
    monkeypatch.setitem(sys.modules, "wfdb", stub_wfdb(mimic_records()))
    got = mimic_io.load_mimic_record(path, lead, target_fs)
    want = jax_mimic.load_mimic_record(path, lead, target_fs)
    if path in ("nan", "no_ii"):
        assert got is None and want is None
        return
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape == (int(10 * target_fs),)
    np.testing.assert_array_equal(got, want)


def test_a_ten_second_record_yields_no_window(monkeypatch):
    """Both packages cut 20-s windows (500 x 20 samples), so a 10-s MIMIC
    record resampled to 500 Hz gives none: a shared behaviour, kept."""
    monkeypatch.setitem(sys.modules, "wfdb", stub_wfdb(mimic_records()))
    paths = ["r250", "r1000"]
    got = extract_cases([0, 1, 2], mimic_io.make_mimic_loader(paths), ExtractionConfig(), progress=False,
                        device="cpu")
    want = jax_extract_cases([0, 1, 2], jax_mimic.make_mimic_loader(paths), JaxExtractionConfig(), progress=False)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.case_id == w.case_id and g.n_windows_raw == w.n_windows_raw == 0
        assert g.waves.shape == w.waves.shape == (0, 320)
