"""PyTorch port: its own copies of the JAX package's framework-free modules
(config composition, the data layer, loggers and callbacks) against the
originals. The copies carry no arithmetic of their own, so everything is
compared for equality: composed configs as dicts, batches bit for bit."""

import numpy as np
import pytest
import torch

from satflow_tpu.core import config as jax_config
from satflow_tpu.data import consts as jax_consts
from satflow_tpu.data.datamodule import SatFlowDataModule as JaxDataModule
from satflow_tpu.data.fake import FakeDataset as JaxFakeDataset
from satflow_tpu_torch.core import config
from satflow_tpu_torch.data import consts
from satflow_tpu_torch.data.datamodule import Prefetcher, SatFlowDataModule
from satflow_tpu_torch.data.fake import FakeDataset
from satflow_tpu_torch.train import callbacks, loggers

DM_KW = dict(fake_data=True, num_workers=0, n_train_data=3, n_val_data=2,
             history_minutes=10, forecast_minutes=20,
             fake_kwargs=dict(batch_size=2, width=16, height=16, number_sat_channels=4))


def _assert_same_tree(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same_tree(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_tree(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("overrides", [
    ["model=convlstm"], ["model=metnet"],
    ["model=convlstm", "datamodule=fake", "trainer=minimal", "callbacks=none",
     "model.hidden_dim=8", "+model.extra=1", "~logger"],
])
def test_compose_matches_the_jax_package(overrides):
    assert config.default_config_dir() == jax_config.default_config_dir()
    ours = config.compose(config.default_config_dir(), "config.yaml", overrides)
    theirs = jax_config.compose(jax_config.default_config_dir(), "config.yaml", overrides)
    assert ours == theirs


def test_instantiate_locates_by_path_or_by_the_callers_mapping():
    node = {"_target_": "collections.OrderedDict", "a": {"_target_": "fractions.Fraction",
                                                         "numerator": 1, "denominator": 2}}
    assert config.instantiate(node) == jax_config.instantiate(node)
    part = config.instantiate({"_target_": "fractions.Fraction", "_partial_": True,
                               "numerator": 3})
    assert part(denominator=4) == 0.75
    built = config.instantiate({"_target_": "anything", "x": [{"_target_": "nested"}]},
                               locate=lambda target: (lambda **kw: (target, kw)))
    assert built == ("anything", {"x": [("nested", {})]})
    with pytest.raises(ImportError, match="Cannot locate"):
        config.instantiate({"_target_": "no.such.module.Class"})


def test_consts_match_the_jax_package():
    names = [n for n in dir(jax_consts) if n.isupper()]
    assert names and names == [n for n in dir(consts) if n.isupper()]
    for n in names:
        assert getattr(consts, n) == getattr(jax_consts, n)


@pytest.mark.parametrize("seed", [0, 7])
def test_fake_dataset_yields_the_same_batches(seed):
    kw = dict(history_minutes=10, forecast_minutes=20, length=3, seed=seed,
              **DM_KW["fake_kwargs"])
    ours, theirs = FakeDataset(**kw), JaxFakeDataset(**kw)
    assert len(ours) == len(theirs) == 3
    for i in range(3):
        _assert_same_tree(ours[i], theirs[i])


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_fake_datamodule_yields_the_same_batches(split):
    ours = SatFlowDataModule(**DM_KW)
    theirs = JaxDataModule(**DM_KW, shard=False)
    a = list(getattr(ours, f"{split}_dataloader")())
    b = list(getattr(theirs, f"{split}_dataloader")())
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        _assert_same_tree(x, y)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_prefetcher_keeps_order_and_delivers_errors(num_workers):
    class Squares:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            if i == 4:
                raise KeyError("batch 4 is broken")
            return np.full(2, i * i)

    got = []
    with pytest.raises(KeyError, match="batch 4"):
        for item in Prefetcher(Squares(), num_workers=num_workers, prefetch=2,
                               device_put=lambda a: torch.from_numpy(a)):
            got.append(item)
    assert [int(t[0]) for t in got] == [0, 1, 4, 9]
    assert all(isinstance(t, torch.Tensor) for t in got)


def test_datamodule_refuses_a_mesh_of_devices():
    with pytest.raises(NotImplementedError, match="item 13"):
        SatFlowDataModule(**DM_KW, device=["cuda:0", "cuda:1"])
    dm = SatFlowDataModule(**DM_KW, device="cpu")
    x, _ = next(iter(dm.train_dataloader()))
    assert isinstance(x[consts.SATELLITE_DATA], torch.Tensor)


def test_missing_configuration_file_raises():
    with pytest.raises(FileNotFoundError, match="no_such.yaml"):
        SatFlowDataModule(configuration_filename="configs/no_such.yaml")
    dm = SatFlowDataModule(
        configuration_filename="satflow_tpu/configs/configurations/local.yaml")
    assert isinstance(dm.configuration, dict) and dm.configuration


def test_loggers_and_callbacks_carry_over(tmp_path):
    hist = loggers.HistoryLogger()
    hist.log_metrics({"train/loss": 1.5}, step=3)
    csv = loggers.CSVLogger(save_dir=str(tmp_path))
    csv.log_metrics({"val/loss": 0.25}, step=1)
    csv.finalize()
    assert "val/loss" in next(tmp_path.rglob("metrics.csv")).read_text()

    class Engine:
        should_stop = False

    stop, engine = callbacks.EarlyStopping(patience=2), Engine()
    for epoch, loss in enumerate([1.0, 1.1, 1.2]):
        stop.on_validation_end(engine, {"val/loss": loss}, epoch)
    assert engine.should_stop
    # the checkpoint callbacks carry over with the JAX constructors' defaults
    import inspect

    from satflow_tpu.train import callbacks as jax_callbacks

    for name in ("ModelCheckpoint", "ModelArtifactLogger"):
        mine, ref = getattr(callbacks, name)(), getattr(jax_callbacks, name)()
        assert str(inspect.signature(type(mine))) == str(inspect.signature(type(ref))), name
        assert vars(mine) == vars(ref), name


# ---------------------------------------------------------------------------
# batch-file stores: the copies read what the originals write, and the same
# ---------------------------------------------------------------------------


def _both(name):
    import importlib

    return (importlib.import_module(f"satflow_tpu_torch.data.{name}"),
            importlib.import_module(f"satflow_tpu.data.{name}"))


def test_npz_store_yields_the_same_split(tmp_path):
    ours, theirs = _both("datasets")
    path = str(tmp_path / "train")
    theirs.write_fake_store(path, n_batches=2, batch_size=2, size=8, seq_length=19)
    kw = dict(history_minutes=30, forecast_minutes=60)
    a, b = ours.SatFlowDataset(2, path, **kw), theirs.SatFlowDataset(2, path, **kw)
    assert len(a) == len(b) == 2 and a.current_timestep_index == b.current_timestep_index == 7
    for i in range(2):
        _assert_same_tree(a[i], b[i])
    # and a store written by the copy reads the same through both
    path2 = str(tmp_path / "val")
    ours.write_fake_store(path2, n_batches=1, batch_size=2, size=8, seq_length=19)
    _assert_same_tree(ours.SatFlowDataset(1, path2, **kw)[0], theirs.SatFlowDataset(1, path2, **kw)[0])


def test_datamodule_reads_a_local_store_onto_the_device(tmp_path):
    ours, _ = _both("datasets")
    for split in ("train", "validation"):
        ours.write_fake_store(str(tmp_path / split), n_batches=2, batch_size=2, size=8,
                              seq_length=19)
    kw = dict(data_path=str(tmp_path), temp_path=str(tmp_path / "tmp"), n_train_data=2,
              n_val_data=2, num_workers=2, history_minutes=30, forecast_minutes=60,
              use_native=False)
    got = list(SatFlowDataModule(device="cpu", **kw).train_dataloader())
    want = list(JaxDataModule(shard=False, **kw).train_dataloader())
    assert len(got) == len(want) == 2
    for (x, y), (xw, yw) in zip(got, want):
        assert all(isinstance(v, torch.Tensor) for v in x.values())
        _assert_same_tree({k: v.numpy() for k, v in x.items()}, xw)
        _assert_same_tree({k: v.numpy() for k, v in y.items()}, yw)


def test_remote_store_fetches_through_a_registered_scheme(tmp_path):
    import os
    import shutil

    ours, _ = _both("datasets")
    remote, _ = _both("remote")
    local = str(tmp_path / "bucket" / "train")
    ours.write_fake_store(local, n_batches=3, batch_size=2, size=8, seq_length=19)
    fetched = []

    def fetch(url, local_path):
        name = remote.split_url(url)[1].rsplit("/", 1)[-1]
        fetched.append(name)
        shutil.copyfile(os.path.join(local, name), local_path)

    assert remote.is_remote("mock://bucket/train") and not remote.is_remote(local)
    remote.register_fetcher("mock", fetch, lambda url: sorted(os.listdir(local)))
    try:
        ds = ours.SatFlowDataset(3, "mock://bucket/train", str(tmp_path / "tmp"), cloud="aws",
                                 history_minutes=30, forecast_minutes=60, cache_size=2)
        x, y = ds[0]
        assert x[consts.SATELLITE_DATA].shape == (2, 7, 8, 8, 12)
        assert y[consts.SATELLITE_DATA].shape == (2, 12, 8, 8, 12)
        _assert_same_tree(ds[0], ours.SatFlowDataset(3, local, history_minutes=30,
                                                     forecast_minutes=60)[0])
        assert fetched == ["batch_0.npz"]  # the second read came from the cache
    finally:
        remote.unregister_fetcher("mock")


def test_sfb_files_round_trip_and_stream_natively(tmp_path):
    """The ``.sfb`` writer and parser of the copy against the original's, and
    the native C++ loader found by path from the port (where it is built)."""
    ours, theirs = _both("datasets")
    native, jax_native = _both("native_ingest")
    assert native._LIB_PATH == jax_native._LIB_PATH
    rng = np.random.default_rng(0)
    batch = {consts.SATELLITE_DATA: rng.random((2, 10, 8, 8, 3)).astype(np.float32),
             consts.TOPOGRAPHIC_DATA: rng.random((2, 8, 8)).astype(np.float32)}
    a, b = str(tmp_path / "a.sfb"), str(tmp_path / "b.sfb")
    native.write_sfb(a, batch)
    jax_native.write_sfb(b, batch)
    assert open(a, "rb").read() == open(b, "rb").read()
    if not native.native_available(auto_build=True):
        pytest.skip("native ingest library not built (no g++)")
    path = str(tmp_path / "train")
    store = ours.SfbBatchStore(path)
    for i in range(3):
        store.write(i, batch)
    x, _ = ours.SatFlowDataset(3, path, history_minutes=30, forecast_minutes=20)[1]
    np.testing.assert_array_equal(x[consts.SATELLITE_DATA], batch[consts.SATELLITE_DATA][:, :7])
    stream = ours.NativeStreamingDataset(path, history_minutes=30, num_threads=2)
    seen = 0
    for x, y in stream:
        np.testing.assert_array_equal(y[consts.SATELLITE_DATA],
                                      batch[consts.SATELLITE_DATA][:, 7:])
        seen += 1
    assert seen == 3
