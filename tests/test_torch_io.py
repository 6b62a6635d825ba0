"""The port's host I/O: the native PNG loader (``native/libdfio.so`` through
ctypes), ``DepthSequence``, the frame sources and ``open_source``
(mirroring ``tests/test_io.py`` and ``tests/test_capture.py``, the
synthetic frames held equal to the JAX package's), and ``PhaseTimer`` and
``trace`` on the CPU. PNGs are written with PIL from seeded numpy."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg
from dynamicfusion_tpu.io import capture as jcapture
from dynamicfusion_tpu_torch.config import DynamicFusionConfig as TCfg
from dynamicfusion_tpu_torch.io import capture, dataset, native_loader
from dynamicfusion_tpu_torch.utils import metrics


@pytest.fixture()
def cfg():
    return TCfg.small(dims=32, rows=48, cols=64)


@pytest.fixture()
def png_dir(tmp_path):
    d = tmp_path / "seq" / "depth"
    d.mkdir(parents=True)
    rng = np.random.RandomState(0)
    arrays = []
    for i in range(6):
        a = rng.randint(0, 5000, (48, 64)).astype(np.uint16)
        Image.fromarray(a).save(d / f"frame_{i:04d}.png")
        arrays.append(a)
    return tmp_path / "seq", arrays


def test_native_loader_is_the_repos_library():
    assert native_loader._LIB_PATH == os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native", "libdfio.so")
    assert native_loader.native_available(), "libdfio.so not built (make -C native)"


def test_read_png16_exact(png_dir):
    root, arrays = png_dir
    p = sorted(os.listdir(root / "depth"))[0]
    out = native_loader.read_png(str(root / "depth" / p))
    assert out.dtype == np.uint16
    np.testing.assert_array_equal(out, arrays[0])


def test_prefetching_sequence_order(png_dir):
    root, arrays = png_dir
    paths = [str(root / "depth" / f) for f in sorted(os.listdir(root / "depth"))]
    seq = native_loader.PrefetchingSequence(paths, threads=3, depth=4)
    for i, frame in enumerate(seq):
        np.testing.assert_array_equal(frame, arrays[i])
    seq.close()


def test_depth_sequence(png_dir):
    root, arrays = png_dir
    ds = dataset.DepthSequence(str(root))
    assert len(ds) == 6
    np.testing.assert_array_equal(ds.depth(3), arrays[3])
    assert ds.color(0) is None
    ds.close()


def test_missing_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        dataset.DepthSequence(str(tmp_path / "nope"))


def test_synthetic_source_is_the_jax_packages(cfg):
    src = capture.SyntheticSource(cfg, 4, amplitude=0.05)
    ref = jcapture.SyntheticSource(JCfg.small(dims=32, rows=48, cols=64), 4, amplitude=0.05)
    frames = list(src)
    assert len(frames) == 4 and src.grab() is None
    for (d, c), (dj, _) in zip(frames, ref):
        assert d.dtype == np.uint16 and d.shape == (cfg.rows, cfg.cols) and c is None
        np.testing.assert_array_equal(d, dj)
    assert (frames[0][0] != frames[2][0]).any()
    assert src.intrinsics() is cfg.intr


def test_dataset_source_reads_depth_and_color(cfg, tmp_path):
    (tmp_path / "depth").mkdir()
    (tmp_path / "color").mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        d = rng.integers(500, 2000, (cfg.rows, cfg.cols)).astype(np.uint16)
        Image.fromarray(d).save(tmp_path / "depth" / f"f_{i:03d}.png")
        c = rng.integers(0, 255, (cfg.rows, cfg.cols, 3)).astype(np.uint8)
        Image.fromarray(c).save(tmp_path / "color" / f"f_{i:03d}.png")
    with capture.DatasetSource(str(tmp_path)) as src:
        assert len(src) == 3
        frames = list(src)
    assert len(frames) == 3
    d, c = frames[0]
    assert d.dtype == np.uint16 and d.shape == (cfg.rows, cfg.cols)
    assert c is not None and c.shape == (cfg.rows, cfg.cols, 3)
    assert capture.DatasetSource(str(tmp_path), with_color=False).grab()[1] is None


def test_openni_gated_without_bindings():
    with pytest.raises(ImportError, match="DatasetSource"):
        capture.OpenNISource(0)
    with pytest.raises(ImportError):
        capture.open_source("openni:0")
    with pytest.raises(ImportError):
        capture.open_source("take.oni")


def test_open_source_specs(cfg, tmp_path):
    src = capture.open_source("synthetic:5", cfg=cfg)
    assert isinstance(src, capture.SyntheticSource) and len(src) == 5
    assert len(capture.open_source("synthetic", cfg=cfg, n_frames=7)) == 7
    with pytest.raises(ValueError):
        capture.open_source("synthetic:5")
    (tmp_path / "depth").mkdir()
    Image.fromarray(np.zeros((8, 8), np.uint16)).save(tmp_path / "depth" / "a.png")
    assert isinstance(capture.open_source(str(tmp_path)), capture.DatasetSource)


def test_phase_timer_on_the_cpu():
    timer = metrics.PhaseTimer()
    x = torch.ones(4)
    for _ in range(3):
        with timer.phase("a", sync=(x, {"y": [x * 2]})):
            x = x + 1
    with timer.phase("b"):
        pass
    assert timer.counts["a"] == 3 and timer.counts["b"] == 1
    assert timer.mean_ms("a") > 0.0 and timer.mean_ms("missing") == 0.0
    assert metrics._devices((x, [x], {"k": x}), set()) == set()  # CPU tensors: nothing to wait for
    lines = timer.report().splitlines()
    assert len(lines) == 2 and "(x3)" in "".join(lines)


def test_trace_writes_a_chrome_trace(tmp_path):
    with metrics.trace(str(tmp_path)):
        torch.ones(8).sum()
    with open(tmp_path / "trace.json") as f:
        assert "traceEvents" in json.load(f)
