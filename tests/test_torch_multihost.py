"""The multi-process path of the port on the CPU, the port of
tests/test_multihost.py: shimmer_tpu_torch/experiments/dryrun_multihost.py
starts two gloo processes of four bands each on a free localhost port;
both return the same image, equal to one process's render of the same
eight bands, and the all-reduced gradient of the sharded training step
equals one process's."""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from shimmer_tpu_torch.experiments import dryrun_multihost as dm
from shimmer_tpu_torch.flagship import flagship, reflectance_grad
from shimmer_tpu_torch.parallel.render import make_tile_mesh, render_sharded
from shimmer_tpu_torch.render import render
from shimmer_tpu_torch.samplers import IndependentSampler

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def test_two_process_dryrun(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "shimmer_tpu_torch.experiments.dryrun_multihost", "--out",
         str(tmp_path), "--timeout", "200"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
    assert "MULTIHOST DRYRUN OK" in proc.stdout
    images = [np.load(tmp_path / f"image{r}.npy") for r in range(dm.N_PROC)]
    grads = [np.load(tmp_path / f"grad{r}.npy") for r in range(dm.N_PROC)]
    assert np.array_equal(images[0], images[1]) and np.array_equal(grads[0], grads[1])

    bands = dm.N_PROC * dm.N_LOCAL
    scene, cam, film = flagship(dm.RES, "cpu")
    kw = dict(spp=2, max_depth=2, wave_spp=2)
    one, _ = render_sharded(scene, cam, film, IndependentSampler(2, seed=3),
                            make_tile_mesh(["cpu"] * bands), **kw)
    np.testing.assert_array_equal(images[0], one.numpy())
    whole, _ = render(scene, cam, film, IndependentSampler(2, seed=3), **kw)
    np.testing.assert_allclose(images[0], whole.numpy(), rtol=1e-5, atol=1e-5)

    _, grad = reflectance_grad(make_tile_mesh(["cpu"] * bands), (16, 8 * bands))
    np.testing.assert_allclose(grads[0], grad.numpy(), rtol=1e-5,
                               atol=1e-5 * float(grad.abs().max()))
