"""The ZSobol kernels' own bodies (csrc/sampler_body.cuh), compiled for the
host with g++ (csrc/sampler_host.cpp), against the torch version of
``samplers.ZSobolSampler`` (which ``test_torch_rng_sampler.py`` holds bit
for bit to the reference): the start's Morton word, sample index and first
dimension, and every draw's floats and advanced dimension, bit for bit.

The cases span every spp from 1 to 64 (odd and even log2 spp), resolutions
up to 65536x65536 (where the index takes all 32 bits and the int64
carrier shifts the top digit's neighbours by 32 or more), dimensions 0-64,
the Morton words 0 and 2^32 - 1 beside random ones, and seeds up to
2^31 + 7.  The device build differs from the host build only in
``reverse_bits`` (``__brev``) and the Sobol' table's memory space; the
card test (``test_torch_sampler_card.py``) holds it to the torch version
too.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from shimmer_tpu_torch import samplers
from shimmer_tpu_torch.ops.cuda_build import CSRC

torch.set_num_threads(1)

SPPS = (1, 2, 4, 8, 16, 32, 64)
RESOLUTIONS = ((64, 64), (1280, 720), (65536, 65536))
SEEDS = (0, 1, 2**31 + 7)
DIMS = np.arange(65)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of the kernel bodies needs it")
    out = tmp_path_factory.mktemp("sampler_host") / "libsampler_host.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(CSRC), str(CSRC / "sampler_host.cpp"), "-o", str(out)],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(out))
    p, ci, i64, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32
    lib.shimmer_zsobol_start_host.argtypes = [p, p, i64, u32, i64, ci, u32, p, p, p]
    lib.shimmer_zsobol_draw_host.argtypes = [p, p, i64, u32, ci, ci, ci, ci, p, p]
    lib.shimmer_zsobol_start_host.restype = ci
    lib.shimmer_zsobol_draw_host.restype = ci
    lib.shimmer_sobol_cols_host.argtypes = [p]
    lib.shimmer_sobol_cols_host.restype = None
    lib.shimmer_permute_digit_host.argtypes = [u32, u32]
    lib.shimmer_permute_digit_host.restype = u32
    return lib


def host_start(lib, pixel_xy, sample_index, log2_spp, dim0=0):
    """The host build's start over (N, 2) pixels; ``sample_index`` an int or
    an (N,) / (1,) tensor; each converted to the kernel's types as
    ``ZSobolSampler.start_pixel_sample`` converts them on the card."""
    n = pixel_xy.shape[0]
    pixel_xy = pixel_xy.to(torch.int32).contiguous()
    outs = [torch.empty(n, dtype=torch.int64) for _ in range(3)]
    if isinstance(sample_index, torch.Tensor):
        sample_index = sample_index.to(torch.int64)
        si, stride, value = sample_index.data_ptr(), int(sample_index.numel() != 1), 0
    else:
        si, stride, value = None, 0, sample_index & 0xFFFFFFFF
    assert lib.shimmer_zsobol_start_host(pixel_xy.data_ptr(), si, stride, value, n, log2_spp,
                                         dim0, *(o.data_ptr() for o in outs)) == 0
    return outs


def host_draw(lib, sampler, morton, dim, width):
    n = morton.shape[0]
    u = torch.empty((n, 2) if width == 2 else (n,), dtype=torch.float32)
    dim_out = torch.empty(n, dtype=torch.int64)
    assert lib.shimmer_zsobol_draw_host(
        morton.data_ptr(), dim.data_ptr(), n, sampler.seed & 0xFFFFFFFF, sampler.log2_spp,
        sampler.n_base4_digits, sampler._index_bits, width, u.data_ptr(),
        dim_out.data_ptr()) == 0
    return u, dim_out


def bits_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_tables_are_the_torch_versions(host):
    cols = (ctypes.c_uint32 * 64)()
    host.shimmer_sobol_cols_host(cols)
    assert np.array_equal(np.array(cols, np.int64).reshape(2, 32), samplers._SOBOL_COLS)
    perms = [[host.shimmer_permute_digit_host(p, d) for d in range(4)] for p in range(24)]
    assert np.array_equal(np.array(perms), samplers._PERMUTATIONS)


def _pixels(res, seed):
    """Corners, edges and random pixels of a res[0] x res[1] image."""
    w, h = res
    rng = np.random.default_rng(seed)
    corners = [(0, 0), (w - 1, 0), (0, h - 1), (w - 1, h - 1), (w // 2, h // 2), (1, h - 2)]
    rand = np.stack([rng.integers(0, w, 58), rng.integers(0, h, 58)], -1)
    return np.concatenate([np.array(corners), rand]).astype(np.int64)


@pytest.mark.parametrize("res", RESOLUTIONS, ids=lambda r: f"{r[0]}x{r[1]}")
@pytest.mark.parametrize("spp", SPPS)
def test_start_bit_exact(host, spp, res):
    """The Morton word, sample index and first dimension, for int32 and
    int64 pixels (pixel coordinates up to 65535 in either) and per-lane,
    one-element and host sample indices."""
    smp = samplers.ZSobolSampler(spp, res)
    px = _pixels(res, spp)
    si = torch.from_numpy(np.random.default_rng(spp).integers(0, spp, px.shape[0]))
    cases = [(torch.from_numpy(px).to(torch.int32), si, 0),
             (torch.from_numpy(px), si.to(torch.int32), 3),
             (torch.from_numpy(px), torch.tensor([spp - 1]), 0),
             (torch.from_numpy(px).to(torch.int32), spp - 1, 7)]
    for pixel_xy, sample_index, dim0 in cases:
        want = smp.start_pixel_sample(pixel_xy, sample_index, dim0)
        got = host_start(host, pixel_xy, sample_index, smp.log2_spp, dim0)
        for g, w in zip(got, (want.pixel_hash, want.sample_index, want.dim)):
            assert torch.equal(g, w.expand_as(g))


def _morton_words(seed, n=40):
    w = np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64).astype(np.int64)
    w[:4] = [0, 2**32 - 1, 1, 2**31]
    return w


@pytest.mark.parametrize("width", (1, 2))
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("res", RESOLUTIONS, ids=lambda r: f"{r[0]}x{r[1]}")
@pytest.mark.parametrize("spp", SPPS)
def test_draw_bit_exact(host, spp, res, seed, width):
    """get_1d (width 1) and get_2d (width 2) over every Morton word at every
    dimension 0-64: the floats and the advanced dimension."""
    smp = samplers.ZSobolSampler(spp, res, seed)
    mm, dd = np.meshgrid(_morton_words(spp * 7 + seed % 97), DIMS, indexing="ij")
    morton, dim = torch.from_numpy(mm.ravel()), torch.from_numpy(dd.ravel())
    state = samplers.SamplerState(pixel_hash=morton, sample_index=torch.zeros_like(morton),
                                  dim=dim)
    want_u, want_state = smp.get_1d(state) if width == 1 else smp.get_2d(state)
    got_u, got_dim = host_draw(host, smp, morton, dim, width)
    assert bits_equal(got_u, want_u)
    assert torch.equal(got_dim, want_state.dim)


def test_index_takes_all_32_bits_at_the_largest_resolution():
    """The largest case reaches every shift the carrier rule covers."""
    smp = samplers.ZSobolSampler(64, (65536, 65536))
    assert smp._index_bits == 32 and 2 * smp.n_base4_digits > 32


def test_arguments_the_kernels_do_not_take_are_refused(host):
    m = torch.zeros(4, dtype=torch.int64)
    u = torch.empty(4, 2)
    for width, log2_spp, digits, bits in ((3, 4, 13, 26), (1, 32, 13, 26), (1, 4, 0, 26),
                                          (2, 4, 13, 33)):
        assert host.shimmer_zsobol_draw_host(m.data_ptr(), m.data_ptr(), 4, 0, log2_spp, digits,
                                             bits, width, u.data_ptr(), m.data_ptr()) == -1
    px = torch.zeros(4, 2, dtype=torch.int32)
    for stride, log2_spp in ((2, 4), (0, 32)):
        assert host.shimmer_zsobol_start_host(px.data_ptr(), m.data_ptr(), stride, 0, 4, log2_spp,
                                              0, m.data_ptr(), m.data_ptr(), m.data_ptr()) == -1
