"""The port's demo app (``apps/demo_torch.py``) end to end in the process, on
the CPU: three synthetic frames at the demo's ``--small`` config with
``--out``. The rendered frames, the canonical cloud with normals, the
meshes and the checkpoint must exist, the PLYs must hold the counts the
demo printed, and the checkpoint must load in the JAX package's
``checkpoint.load``, equal to the run's state leaf by leaf."""

import dataclasses
import importlib.util
import os

import jax
import numpy as np
import pytest

from dynamicfusion_tpu.config import DynamicFusionConfig as JCfg
from dynamicfusion_tpu.utils import checkpoint as jckpt
from dynamicfusion_tpu_torch.utils import checkpoint as tckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _demo():
    spec = importlib.util.spec_from_file_location("demo_torch", os.path.join(REPO, "apps", "demo_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ply_counts(path):
    """(vertices, faces) from a PLY header."""
    counts = {"vertex": 0, "face": 0}
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"element"):
                _, name, n = line.split()
                counts[name.decode()] = int(n)
            if line.startswith(b"end_header"):
                break
    return counts["vertex"], counts["face"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("demo")
    res = _demo().main(["--device", "cpu", "--small", "--synthetic", "3", "--out", str(out), "--orbit", "1",
                        "--show-warp"])
    return out, res


def test_artifacts(run):
    out, res = run
    names = sorted(os.listdir(out))
    assert [n for n in names if n.startswith("frame_")] == [f"frame_{i:05d}.png" for i in range(3)]
    assert "orbit_000.png" in names
    v, _ = _ply_counts(out / "canonical_cloud.ply")
    assert v > 200
    for name in ("canonical_mesh.ply", "live_mesh.ply"):
        assert _ply_counts(out / name) == res["meshes"][name]
        assert res["meshes"][name][0] > 100 and res["meshes"][name][1] > 100
    assert res["df"].device.type == "cpu"
    assert res["timer"].counts["frame"] == 3


def test_checkpoint_loads_in_jax(run):
    out, res = run
    jcfg = dataclasses.replace(JCfg.small(dims=64, rows=120, cols=160), max_nodes=256, node_sample_step=7)
    state = jckpt.load(str(out / "final_state.npz"), jcfg)
    assert state.vol.tsdf.shape == (64, 64, 64) and float(state.vol.weight.max()) > 0
    jflat = jax.tree.flatten(state)[0]
    tflat = tckpt.leaves(res["df"].state)
    assert len(jflat) == len(tflat)
    for j, t in zip(jflat, tflat):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
