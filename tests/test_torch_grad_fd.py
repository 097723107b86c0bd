"""tests/test_grad.py::TestGradients in the port: each case's AD against
the port's own central finite difference, at that file's sizes, steps and
tolerances, and nonzero as it requires (tests/torch_grad.py, ``CASES``)."""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import pytest
import torch

from torch_grad import CASES, FD_SIZE, case_scenes, check_sign, port_fd_vs_ad

torch.set_num_threads(1)


@pytest.mark.parametrize("name", list(CASES))
def test_ad_matches_fd(name):
    case = CASES[name]
    jscene, scene = case_scenes(name)
    g_ad, _ = port_fd_vs_ad(case.port_f(scene, jscene, *FD_SIZE), case.theta0(jscene),
                            **case.fd)
    check_sign(case, g_ad)
