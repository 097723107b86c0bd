"""Counter-based RNG and ZSobol sampler of the port against the reference:
the uint32 streams are bit-exact (the port holds uint32 words in int64),
the wavelength warp agrees to float32 rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shimmer_tpu import samplers as jsamp
from shimmer_tpu.ops import rng as jrng
from shimmer_tpu.spectra.sampled import SampledWavelengths as JSWL
from shimmer_tpu_torch import samplers as tsamp
from shimmer_tpu_torch.ops import rng as trng
from shimmer_tpu_torch.spectra.sampled import SampledWavelengths as TSWL
from torch_parity import assert_parity

torch.set_num_threads(1)

RES = (1280, 720)
N_SAMPLES = 16
N_DIMS = 41


def _u32_words(seed, n=4096):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    w[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]
    return w


def _jax_u32(x):
    return jnp.asarray(x, jnp.uint32)


def test_pcg_hash_bit_exact():
    w = _u32_words(0)
    assert_parity(
        lambda x: jrng.pcg_hash(_jax_u32(x)),
        lambda x: trng.pcg_hash(x.to(torch.int64)),
        w.astype(np.int64),
    )


def test_pcg3d_and_hash_combine_bit_exact():
    a, b, c = _u32_words(1), _u32_words(2), _u32_words(3)
    assert_parity(
        lambda x, y, z: jrng.pcg3d(_jax_u32(x), _jax_u32(y), _jax_u32(z))
        + (jrng.hash_combine(_jax_u32(x), _jax_u32(y), jnp.uint32(7)),),
        lambda x, y, z: trng.pcg3d(x, y, z) + (trng.hash_combine(x, y, 7),),
        a.astype(np.int64), b.astype(np.int64), c.astype(np.int64),
    )


def _grid():
    """(pixel, sample, dimension) lanes: image corners and edges plus
    random pixels, samples 0..15, dimensions 0..40."""
    rng = np.random.default_rng(4)
    corners = [(0, 0), (1279, 0), (0, 719), (1279, 719), (640, 360), (1, 718)]
    px = np.concatenate([np.array(corners), rng.integers(0, RES, size=(10, 2))])
    pp, ss, dd = np.meshgrid(
        np.arange(len(px)), np.arange(N_SAMPLES), np.arange(N_DIMS), indexing="ij"
    )
    return px[pp.ravel()].astype(np.int32), ss.ravel().astype(np.int64), dd.ravel().astype(np.int64)


@pytest.mark.parametrize("spp", [2, 4, 16])
@pytest.mark.parametrize("draw", ["get_1d", "get_2d", "get_pixel_2d"])
def test_zsobol_bit_exact(spp, draw):
    px, si, dim = _grid()
    js = jsamp.ZSobolSampler(spp, RES)
    ts = tsamp.ZSobolSampler(spp, RES)

    def jax_fn(px, si, dim):
        st = js.start_pixel_sample(px, si.astype(jnp.uint32))
        st = jsamp.SamplerState(st.pixel_hash, st.sample_index, dim.astype(jnp.uint32))
        u, st2 = getattr(js, draw)(st)
        return u, st2.dim, st.pixel_hash

    def torch_fn(px, si, dim):
        st = ts.start_pixel_sample(px, si)
        st = tsamp.SamplerState(st.pixel_hash, st.sample_index, dim)
        u, st2 = getattr(ts, draw)(st)
        return u, st2.dim, st.pixel_hash

    assert_parity(jax_fn, torch_fn, px, si, dim)


@pytest.mark.parametrize("field", ["lam", "pdf"])
def test_sample_visible_wavelengths(field):
    u = np.random.default_rng(5).random(20000).astype(np.float32)
    u[:3] = [0.0, 0.5, np.nextafter(np.float32(1.0), np.float32(0.0))]
    # atanh / cosh differ in the last ulp between XLA and torch: the
    # wavelengths agree to 1e-6.  The pdf 0.00394 / cosh(0.0072 (lam -
    # 538))^2 amplifies a 1-ulp wavelength difference by up to ~2 x 2.1
    # near 830 nm and adds cosh's own rounding, so it gets 4e-6.
    rtol = {"lam": 1e-6, "pdf": 4e-6}[field]
    assert_parity(
        lambda u: getattr(JSWL.sample_visible(u), field),
        lambda u: getattr(TSWL.sample_visible(u), field),
        u, rtol=rtol,
    )
