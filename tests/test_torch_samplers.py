"""The Independent and Stratified samplers, ``create_sampler`` and the
counter-based uniform draws of the port against the reference, on the
CPU: every stream bit-equal (the port holds uint32 words in int64, and a
stratified stratum's uint32 sum wraps before its modulo)."""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shimmer_tpu import samplers as jsamp
from shimmer_tpu.ops import rng as jrng
from shimmer_tpu_torch import samplers as tsamp
from shimmer_tpu_torch.ops import rng as trng
from torch_parity import assert_parity

torch.set_num_threads(1)

RES = (1280, 720)


def _words(seed, n=4096):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, size=n, dtype=np.uint64)
    w[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]
    return w.astype(np.int64)


def _u32(x):
    return jnp.asarray(x, jnp.uint32)


@pytest.mark.parametrize("draw", ["uniform_1d", "uniform_2d", "uniform_3d"])
def test_uniform_draws_bit_exact(draw):
    a, b, c = _words(1), _words(2), _words(3)
    assert_parity(lambda x, y, z: getattr(jrng, draw)(_u32(x), _u32(y), _u32(z)),
                  lambda x, y, z: getattr(trng, draw)(x, y, z), a, b, c)


def test_pcg4d_bit_exact():
    a, b, c, d = _words(4), _words(5), _words(6), _words(7)
    assert_parity(lambda x, y, z, w: jrng.pcg4d(_u32(x), _u32(y), _u32(z), _u32(w)),
                  lambda x, y, z, w: trng.pcg4d(x, y, z, w), a, b, c, d)


def _grid(n_samples):
    """(pixel, sample, dimension) lanes: corners and random pixels, every
    sample index below n_samples plus indices near 2^32 (where the
    stratum's sum wraps), dimensions 0..40."""
    rng = np.random.default_rng(8)
    px = np.concatenate([np.array([(0, 0), (1279, 719), (640, 360)]),
                         rng.integers(0, RES, size=(6, 2))])
    samples = np.concatenate([np.arange(n_samples), [2**32 - 1, 2**32 - 7]])
    pp, ss, dd = np.meshgrid(np.arange(len(px)), np.arange(len(samples)), np.arange(41),
                             indexing="ij")
    return (px[pp.ravel()].astype(np.int32), samples[ss.ravel()].astype(np.int64),
            dd.ravel().astype(np.int64))


def _samplers(kind, seed):
    if kind == "independent":
        return jsamp.IndependentSampler(16, seed), tsamp.IndependentSampler(16, seed)
    if kind == "stratified":
        return jsamp.StratifiedSampler(4, 3, True, seed), tsamp.StratifiedSampler(4, 3, True, seed)
    return jsamp.StratifiedSampler(3, 5, False, seed), tsamp.StratifiedSampler(3, 5, False, seed)


@pytest.mark.parametrize("kind", ["independent", "stratified", "stratified_nojitter"])
@pytest.mark.parametrize("draw", ["get_1d", "get_2d", "get_pixel_2d"])
def test_sampler_bit_exact(kind, draw):
    js, ts = _samplers(kind, seed=11)
    px, si, dim = _grid(js.samples_per_pixel)

    def jax_fn(px, si, dim):
        st = js.start_pixel_sample(px, si.astype(jnp.uint32))
        st = jsamp.SamplerState(st.pixel_hash, st.sample_index, dim.astype(jnp.uint32))
        u, st2 = getattr(js, draw)(st)
        return u, st2.dim, st.pixel_hash, st.sample_index

    def torch_fn(px, si, dim):
        st = ts.start_pixel_sample(px, si)
        st = tsamp.SamplerState(st.pixel_hash, st.sample_index, dim)
        u, st2 = getattr(ts, draw)(st)
        return u, st2.dim, st.pixel_hash, st.sample_index

    assert_parity(jax_fn, torch_fn, px, si, dim)


def test_stratified_covers_every_stratum():
    """Without jitter each dimension's spp draws of a pixel are the spp
    stratum centres, in a shuffled order."""
    ts = tsamp.StratifiedSampler(2, 2, False, 0)
    px = torch.tensor([[5, 7]] * 4, dtype=torch.int32)
    st = ts.start_pixel_sample(px, torch.arange(4))
    for _ in range(6):
        u, st = ts.get_1d(st)
        assert sorted(u.tolist()) == [0.125, 0.375, 0.625, 0.875]


@pytest.mark.parametrize("name, spp", [("independent", 8), ("stratified", 16), ("stratified", 6),
                                       ("zsobol", 4), ("sobol", 2), ("paddedsobol", 8)])
def test_create_sampler_matches_reference(name, spp):
    js = jsamp.create_sampler(name, spp, (64, 48), seed=3)
    ts = tsamp.create_sampler(name, spp, (64, 48), seed=3)
    assert type(ts).__name__ == type(js).__name__
    assert ts.samples_per_pixel == js.samples_per_pixel and ts.seed == js.seed
    for attr in ("x_samples", "y_samples", "jitter", "log2_spp", "n_base4_digits"):
        assert getattr(ts, attr, None) == getattr(js, attr, None), attr
    px = np.stack(np.meshgrid(np.arange(64), np.arange(48)), -1).reshape(-1, 2).astype(np.int32)

    def draws(s, px, si, xp):
        st = s.start_pixel_sample(px, si)
        out = []
        for _ in range(5):
            u, st = s.get_2d(st)
            out.append(u)
            v, st = s.get_1d(st)
            out.append(v[..., None])
        return xp.concatenate(out, -1)

    a = np.asarray(draws(js, jnp.asarray(px), jnp.uint32(spp - 1), jnp))
    b = draws(ts, torch.from_numpy(px), torch.tensor(spp - 1), torch).numpy()
    np.testing.assert_array_equal(b, a)


def test_create_sampler_rejects_unknown():
    with pytest.raises(ValueError, match="unknown sampler"):
        tsamp.create_sampler("halton", 4)
    with pytest.raises(ValueError):
        jsamp.create_sampler("halton", 4)
