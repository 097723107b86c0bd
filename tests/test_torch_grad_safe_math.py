"""The port's ``safe_sqrt``, ``safe_asin`` and ``safe_acos`` against the
reference's custom JVPs (shimmer_tpu/ops/math.py): the values (the root
bit for bit, asin and acos within an ulp: torch's and XLA's CPU
transcendentals round an ulp apart), and the derivatives, inside the domain and at and beyond its edges
(x = 0, x < 0, |x| = 1, |x| > 1, and within 1e-7 of 1), equal to
``jax.grad`` of the reference within rtol 1e-6 and finite everywhere.
A masked lane (``torch.where`` selecting another branch) passes a zero
gradient, not 0 * inf = NaN."""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shimmer_tpu.ops import math as jax_math
from shimmer_tpu_torch.ops import math as port_math

torch.set_num_threads(1)

POINTS = {
    "safe_sqrt": [-4.0, -1e-6, 0.0, 1e-13, 1e-12, 2e-12, 1e-6, 0.25, 1.0, 9.0],
    "safe_asin": [-2.0, -1.0, -0.9999999, -0.99999, -0.5, 0.0, 0.3, 0.99999, 0.9999999, 1.0,
                  1.5],
    "safe_acos": [-2.0, -1.0, -0.9999999, -0.99999, -0.5, 0.0, 0.3, 0.99999, 0.9999999, 1.0,
                  1.5],
}


@pytest.mark.parametrize("name", list(POINTS))
def test_values_and_gradients_match_reference(name):
    x = np.asarray(POINTS[name], np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = getattr(port_math, name)(xt)
    (g,) = torch.autograd.grad(y.sum(), xt)
    jfn = getattr(jax_math, name)
    jy = np.asarray(jfn(jnp.asarray(x)))
    jg = np.asarray(jax.vmap(jax.grad(jfn))(jnp.asarray(x)))
    if name == "safe_sqrt":
        np.testing.assert_array_equal(y.detach().numpy(), jy)
    else:
        np.testing.assert_array_max_ulp(y.detach().numpy(), jy, maxulp=1)
    assert np.isfinite(g.numpy()).all()
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("name", list(POINTS))
def test_masked_lane_gives_zero_gradient(name):
    """The unselected branch of a where at the domain's edge: the plain
    ops would give 0 * inf = NaN there."""
    x = torch.tensor([0.0 if name == "safe_sqrt" else 1.0, 0.5], requires_grad=True)
    y = torch.where(torch.tensor([False, True]), getattr(port_math, name)(x), 0.0)
    (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.isfinite(g).all() and g[0] == 0.0 and g[1] != 0.0
