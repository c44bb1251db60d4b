"""PyTorch port, the data layer's last copies and the MetNet example: the
port's own ``data/transforms.py``, ``data/geo.py`` and ``data/convert.py``
against the JAX package's (pure numpy on both sides, so everything is held
bit for bit, on the inputs of ``tests/test_geo.py``), the ``.sfb``
conversion CLI byte for byte, and ``examples/metnet_example.py`` on the CPU
in a process that imports no JAX."""

import datetime
import os
import subprocess
import sys

import numpy as np
import pytest

from satflow_tpu.data import convert as jax_convert
from satflow_tpu.data import geo as jax_geo
from satflow_tpu.data import transforms as jax_transforms
from satflow_tpu_torch.data import convert, geo, transforms
from satflow_tpu_torch.data.datasets import write_fake_store

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _small_areas(mod):
    src = mod.MSG_FULL_DISC_3KM
    small_src = mod.AreaDefinition(projection=src.projection, width=src.width // 16,
                                   height=src.height // 16, area_extent=src.area_extent)
    small_dst = mod.AreaDefinition(projection=mod.EUROPE_TM_AREA.projection, width=32,
                                   height=32, area_extent=mod.EUROPE_TM_AREA.area_extent)
    return small_src, small_dst


LON = np.array([-5.0, 0.0, 10.0, 18.0, 25.0])
LAT = np.array([35.0, 45.0, 52.0, 60.0, 68.0])
# (what, the call on a module: ``geo`` or ``transforms``)
GEO_CASES = {
    "tmerc_forward": lambda g: g.TransverseMercator(lon_0=10.0, k0=0.9996).forward(LON, LAT),
    "tmerc_inverse": lambda g: g.TransverseMercator(lon_0=10.0, k0=0.9996).inverse(
        *g.TransverseMercator(lon_0=10.0, k0=0.9996).forward(LON, LAT)),
    "tmerc_meridian": lambda g: g.TransverseMercator(
        lon_0=3.0, k0=0.9996, false_easting=500_000.0).forward(3.0, 48.8584),
    "geos_roundtrip": lambda g: g.Geostationary(
        lon_0=0.0, satellite_height=35_785_831.0, sweep="y", ellipsoid=None).inverse(
        *g.Geostationary(lon_0=0.0, satellite_height=35_785_831.0, sweep="y",
                         ellipsoid=None).forward(np.array([-20.0, 0.0, 15.0, 40.0]),
                                                 np.array([-30.0, 10.0, 48.0, 5.0]))),
    "geos_far_side": lambda g: g.Geostationary(lon_0=0.0).forward(180.0, 0.0),
    "area_lonlats": lambda g: g.EUROPE_TM_AREA.lonlats(),
    "area_pixel": lambda g: g.EUROPE_TM_AREA.lonlat_to_pixel(
        *(a[100, 200] for a in g.EUROPE_TM_AREA.lonlats())),
    "resample_identity": lambda g: g.resample_area(
        np.random.default_rng(0).random((32, 32)).astype(np.float32),
        *(g.AreaDefinition(projection={"proj": "tmerc", "lon_0": 10.0, "k": 0.9996},
                           width=32, height=32,
                           area_extent=(-400_000, 4_500_000, 400_000, 5_300_000)),) * 2,
        fill_value=-1),
    "resample_msg_to_tm": lambda g: g.resample_area(
        np.linspace(0, 1, g.MSG_FULL_DISC_3KM.height, dtype=np.float32)[:, None]
        + np.linspace(0, 1, g.MSG_FULL_DISC_3KM.width, dtype=np.float32)[None, :],
        g.MSG_FULL_DISC_3KM,
        g.AreaDefinition(projection=g.EUROPE_TM_AREA.projection, width=64, height=64,
                         area_extent=g.EUROPE_TM_AREA.area_extent), fill_value=np.nan),
}


@pytest.mark.parametrize("case", list(GEO_CASES))
def test_geo_is_bit_equal_to_the_jax_copy(case):
    """Projections, areas and resampling on ``tests/test_geo.py``'s inputs."""
    _same(GEO_CASES[case](geo), GEO_CASES[case](jax_geo))


def test_transforms_are_bit_equal_to_the_jax_copy():
    """Every function of ``transforms``: the datetime regex, the mask, the
    coordinate and time planes, the channel count, the batched reprojection
    (``tests/test_geo.py``'s frames), the standardizers and the re-exported
    ``crop_center``."""
    name = "MSG4-SEVI-MSG15-0100-NA-20210317121243.683000000Z-NA.nat"
    assert transforms.eumetsat_name_to_datetime(name) == \
        jax_transforms.eumetsat_name_to_datetime(name) == datetime.datetime(2021, 3, 17, 12, 12)
    with pytest.raises(ValueError, match="No datetime"):
        transforms.eumetsat_name_to_datetime("no-date.nat")
    rng = np.random.default_rng(1)
    mask = rng.random((5, 7))
    _same(transforms.binarize_mask(mask, 0.3), jax_transforms.binarize_mask(mask, 0.3))
    for with_r in (False, True):
        _same(transforms.create_pixel_coord_layers(9, 13, with_r),
              jax_transforms.create_pixel_coord_layers(9, 13, with_r))
    dt = datetime.datetime(2021, 3, 17, 13, 45)
    _same(transforms.create_time_layer(dt, (4, 6)), jax_transforms.create_time_layer(dt, (4, 6)))
    kw = dict(sat_channels=("a", "b"), nwp_channels=("c",), use_topo=True, use_latlon=True,
              use_time=True, use_mask=False)
    assert transforms.check_channels(**kw) == jax_transforms.check_channels(**kw) == 10
    frames = rng.random((2, 3, 3712 // 16, 3712 // 16))
    _same(transforms.map_satellite_to_mercator(frames=frames, src_area=_small_areas(geo)[0],
                                               dst_area=_small_areas(geo)[1]),
          jax_transforms.map_satellite_to_mercator(
              frames=frames, src_area=_small_areas(jax_geo)[0],
              dst_area=_small_areas(jax_geo)[1]))
    x = rng.normal(size=(4, 5, 6, 3)) * 3 + 1
    mean, std = x.mean(axis=(0, 1, 2)), x.std(axis=(0, 1, 2))
    for fn in ("__call__", "inverse"):
        _same(getattr(transforms.Standardizer(mean, std), fn)(x),
              getattr(jax_transforms.Standardizer(mean, std), fn)(x))
    _same(transforms.normalize_per_channel(x), jax_transforms.normalize_per_channel(x))
    _same(transforms.normalize_per_channel(x, {"mean": mean, "std": std}),
          jax_transforms.normalize_per_channel(x, {"mean": mean, "std": std}))
    _same(transforms.crop_center(x, 3, 4), np.asarray(jax_transforms.crop_center(x, 3, 4)))


@pytest.mark.parametrize("kwargs", [{}, dict(start=1, limit=2), dict(start=1, limit=2,
                                                                     reindex=True)],
                         ids=["all", "range", "reindex"])
def test_convert_writes_the_jax_bytes(tmp_path, kwargs):
    """``convert`` of one npz store through the port and through the JAX
    package: the same ``.sfb`` files, byte for byte, and the same count."""
    src = str(tmp_path / "npz")
    write_fake_store(src, n_batches=3, batch_size=2, size=8, seq_length=5, sat_channels=3)
    n = convert.convert(src, str(tmp_path / "port"), verbose=False, **kwargs)
    assert n == jax_convert.convert(src, str(tmp_path / "jax"), verbose=False, **kwargs)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files and sorted(os.listdir(tmp_path / "port")) == files
    for name in files:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    with pytest.raises(ValueError, match="at/past the end"):
        convert.convert(src, str(tmp_path / "none"), start=3, verbose=False)


def test_convert_cli_and_example_import_no_jax(tmp_path):
    """``python -m satflow_tpu_torch.data.convert`` converts a store, and
    ``python -m satflow_tpu_torch.examples.metnet_example --device cpu`` runs
    (1, 7, 256, 256, 17) -> (1, 24, 16, 16, 1), each in a process that imports
    neither jax, flax, optax nor the JAX package."""
    src = str(tmp_path / "npz")
    write_fake_store(src, n_batches=2, batch_size=2, size=8, seq_length=5, sat_channels=3)
    guard = ("import runpy, sys\n"
             "sys.argv = [sys.argv[1]] + sys.argv[2:]\n"
             "runpy.run_module(sys.argv[0], run_name='__main__')\n"
             "bad = sorted(m for m in sys.modules\n"
             "             if m.split('.')[0] in ('jax', 'flax', 'optax', 'satflow_tpu'))\n"
             "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    for args in (["satflow_tpu_torch.data.convert", src, str(tmp_path / "sfb")],
                 ["satflow_tpu_torch.examples.metnet_example", "--device", "cpu"]):
        out = subprocess.run([sys.executable, "-c", guard, *args], capture_output=True,
                             text=True, cwd=tmp_path, env=env, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
    assert sorted(os.listdir(tmp_path / "sfb")) == ["batch_0.sfb", "batch_1.sfb"]
    assert "output (1, 24, 16, 16, 1)" in out.stdout
