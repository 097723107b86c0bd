"""The port's command-line renderer (shimmer_tpu_torch/cli.py) on the CPU:
``main`` renders tests/scenes/diffuse_box.pbrt at 1 spp with
``--device cpu`` to a PFM and a PNG; the PFM read back equals the image
``render`` returns for the same job; the PNG is the 8-bit sRGB encoding;
``python -m shimmer_tpu_torch.cli`` runs; ``--integrator simplepath`` /
``randomwalk`` and ``--megakernel`` write the image ``render`` gives with
that estimator or the megakernel; ``--checkpoint`` resumes a killed
render to the uninterrupted image and ``--stats`` prints the report;
``--shard --device cpu`` writes the image the run without it writes
(wavefront and ``--megakernel``), ``--shard`` with ``--checkpoint`` or
``--stats`` raises NotImplementedError, and ``--device cuda`` without a
card raises instead of falling back to the CPU."""

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from shimmer_tpu_torch import cli
from shimmer_tpu_torch.film.image import Image, linear_to_srgb
from shimmer_tpu_torch.loading.parser import parse_file
from shimmer_tpu_torch.loading.scene_builder import SceneBuilder
from shimmer_tpu_torch.render import render

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SCENE = Path(__file__).parent / "scenes" / "diffuse_box.pbrt"


@pytest.fixture(scope="module")
def reference_image():
    builder = SceneBuilder(search_dir=SCENE.parent)
    parse_file(str(SCENE), builder)
    job = builder.create(device="cpu")
    image, _ = render(job.scene, job.camera, job.film, job.sampler, integrator="path", spp=1,
                      max_depth=job.max_depth)
    return image.numpy()


def test_cli_writes_pfm_and_png(tmp_path, reference_image):
    pfm, png = tmp_path / "out.pfm", tmp_path / "out.png"
    assert cli.main([str(SCENE), "--spp", "1", "--device", "cpu", "-q", "-o", str(pfm)]) == 0
    assert cli.main([str(SCENE), "--spp", "1", "--device", "cpu", "-q", "--outfile", str(png)]) == 0
    img = Image.read(pfm)
    assert img.resolution == (64, 64) and img.data.dtype == np.float32
    np.testing.assert_array_equal(img.data, reference_image)
    from PIL import Image as PILImage

    enc = np.asarray(PILImage.open(png))
    want = (np.clip(linear_to_srgb(reference_image.astype(np.float64)), 0, 1) * 255 + 0.5)
    np.testing.assert_array_equal(enc, want.astype(np.uint8))
    with pytest.raises(NotImplementedError):
        Image(reference_image).write(tmp_path / "out.exr")


def test_cli_as_module(tmp_path):
    out = tmp_path / "mod.pfm"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "shimmer_tpu_torch.cli", str(SCENE), "--spp", "1", "--maxdepth",
         "1", "--device", "cpu", "-o", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "wrote" in proc.stderr and np.isfinite(Image.read(out).data).all()


@pytest.mark.parametrize("flags", [[], ["--megakernel"]], ids=["wavefront", "megakernel"])
def test_shard_writes_the_unsharded_image(tmp_path, flags):
    plain, sharded = tmp_path / "plain.pfm", tmp_path / "sharded.pfm"
    args = [str(SCENE), "--spp", "1", "--device", "cpu", "-q", *flags]
    assert cli.main([*args, "-o", str(plain)]) == 0
    assert cli.main([*args, "--shard", "-o", str(sharded)]) == 0
    np.testing.assert_array_equal(Image.read(sharded).data, Image.read(plain).data)


@pytest.mark.parametrize("flags", [["--checkpoint", "ck.npz"], ["--stats"]],
                         ids=["checkpoint", "stats"])
def test_shard_refuses_checkpoint_and_stats(tmp_path, flags):
    with pytest.raises(NotImplementedError, match="--shard keeps no checkpoint"):
        cli.main([str(SCENE), "--device", "cpu", "-q", "--shard", "-o", str(tmp_path / "x.pfm"),
                  *flags])
    assert not (tmp_path / "x.pfm").exists()


@pytest.mark.parametrize(
    "flags, kwargs",
    [(["--integrator", "simplepath"], {"integrator": "simplepath"}),
     (["--integrator", "randomwalk"], {"integrator": "randomwalk"}),
     (["--megakernel"], {"wavefront": False})],
    ids=["simplepath", "randomwalk", "megakernel"],
)
def test_estimator_flags_render(tmp_path, reference_image, flags, kwargs):
    pfm = tmp_path / "est.pfm"
    assert cli.main([str(SCENE), "--spp", "1", "--device", "cpu", "-q", "-o", str(pfm),
                     *flags]) == 0
    builder = SceneBuilder(search_dir=SCENE.parent)
    parse_file(str(SCENE), builder)
    job = builder.create(device="cpu")
    want, _ = render(job.scene, job.camera, job.film, job.sampler, spp=1,
                     max_depth=job.max_depth, **kwargs)
    np.testing.assert_array_equal(Image.read(pfm).data, want.numpy())
    if "--megakernel" in flags:
        # The same estimator and draws as the wavefront's image.
        np.testing.assert_allclose(want.numpy(), reference_image, rtol=1e-4, atol=1e-5)


def test_no_silent_cpu_fallback(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main([str(SCENE), "-q", "-o", str(tmp_path / "x.pfm")])


def test_render_interface(reference_image):
    """``render`` takes the reference's keywords in the reference's order,
    returns (image, state), or (image, state, stats) with collect_stats;
    film_state accumulates onto a given state and progress sees every
    wave; the megakernel, the other estimators, their options,
    ``regularize`` and the jitter switches render; ``checkpoint_path``
    saves and resumes."""
    import inspect

    from shimmer_tpu.render import render as jax_render

    assert list(inspect.signature(render).parameters) == list(
        inspect.signature(jax_render).parameters)
    builder = SceneBuilder(search_dir=SCENE.parent)
    parse_file(str(SCENE), builder)
    job = builder.create(device="cpu")
    args = (job.scene, job.camera, job.film, job.sampler)
    seen = []
    image, state, stats = render(*args, spp=2, max_depth=job.max_depth, wave_spp=1,
                                 collect_stats=True, progress=lambda d, t: seen.append((d, t)))
    assert seen == [(1, 2), (2, 2)] and stats["rays"] > 0 and stats["iters"] > 0
    one, state1 = render(*args, spp=1, max_depth=job.max_depth)
    np.testing.assert_array_equal(one.numpy(), reference_image)
    _, state2 = render(*args, spp=1, max_depth=job.max_depth, film_state=state1)
    assert (state2.weight_sum.numpy() == 2).all()
    np.testing.assert_array_equal(state2.rgb_sum.numpy(), 2 * state1.rgb_sum.numpy())
    for kwargs in ({"integrator": "simplepath"}, {"wavefront": False},
                   {"integrator": "simplepath", "integrator_options": {"sample_bsdf": False}},
                   {"regularize": True}, {"disable_pixel_jitter": True},
                   {"disable_wavelength_jitter": True}):
        img, _ = render(*args, spp=1, max_depth=2, **kwargs)
        assert torch.isfinite(img).all() and float(img.mean()) > 0, kwargs
    # A checkpoint saved after the last wave: a second call resumes at
    # the end and gives the same image without rendering.
    with tempfile.TemporaryDirectory() as tmp:
        ck = Path(tmp) / "ck.npz"
        first, _ = render(*args, spp=1, max_depth=job.max_depth, checkpoint_path=ck)
        again, _ = render(*args, spp=1, max_depth=job.max_depth, checkpoint_path=ck,
                          progress=lambda d, t: seen.append("rendered"))
    assert torch.equal(first, again) and "rendered" not in seen
    np.testing.assert_array_equal(first.numpy(), reference_image)


class _Killed(Exception):
    pass


def test_cli_checkpoint_resumes(tmp_path):
    """A render killed after its first wave leaves a checkpoint under the
    CLI's fingerprint; ``--checkpoint`` resumes it to the image of an
    uninterrupted ``main`` run."""
    builder = SceneBuilder(search_dir=SCENE.parent)
    parse_file(str(SCENE), builder)
    job = builder.create(device="cpu")
    ck = tmp_path / "box.ckpt.npz"

    def kill(done, total):
        raise _Killed

    with pytest.raises(_Killed):
        render(job.scene, job.camera, job.film, job.sampler, integrator=job.integrator, spp=2,
               max_depth=job.max_depth, wave_spp=1, checkpoint_path=ck, progress=kill)
    flags = ["--spp", "2", "--wave-spp", "1", "--device", "cpu", "-q"]
    resumed, whole = tmp_path / "resumed.pfm", tmp_path / "whole.pfm"
    assert cli.main([str(SCENE), *flags, "--checkpoint", str(ck), "-o", str(resumed)]) == 0
    assert cli.main([str(SCENE), *flags, "-o", str(whole)]) == 0
    with np.load(ck) as z:
        assert int(z["spp_done"]) == 2
    np.testing.assert_array_equal(Image.read(resumed).data, Image.read(whole).data)


def test_cli_stats_prints_report(tmp_path):
    import contextlib
    import io

    from shimmer_tpu_torch.utils import stats

    stats.clear()
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        assert cli.main([str(SCENE), "--spp", "1", "--device", "cpu", "-q", "--stats",
                         "-o", str(tmp_path / "s.pfm")]) == 0
    err = buf.getvalue()
    stats.clear()
    assert "Statistics:" in err and "Rays traced" in err and "Wave time" in err
    assert "Pixel samples" in err and "4.10k" in err
