"""The walks' graph cache on the CPU (``materials/walk_graph.py``): where
it never engages, the constants the walks share, and the cache itself
with a stub in place of the CUDA capture.  The card's replays are held
to the eager walk in tests/test_torch_walk_graph_card.py."""

import dataclasses

import pytest
import torch

from shimmer_tpu_torch import config
from shimmer_tpu_torch.materials import bxdf as bx
from shimmer_tpu_torch.materials import conductor_dielectric as cd
from shimmer_tpu_torch.materials import layered, walk_graph
from shimmer_tpu_torch.materials import scattering as sc
from shimmer_tpu_torch.utils import stats
from test_torch_walk_graph_card import call, tables, walk_inputs

CPU = torch.device("cpu")


@pytest.fixture
def fresh(monkeypatch):
    monkeypatch.setattr(walk_graph, "_CACHE", walk_graph.WalkGraphs())
    stats.clear()
    yield
    stats.clear()


@pytest.mark.parametrize("walk", ["f", "sample", "pdf"])
def test_the_cpu_runs_every_walk_eagerly_and_says_why(fresh, walk):
    materials, spectra = tables(CPU)
    for mk in (layered.COATED_DIFFUSE, layered.COATED_CONDUCTOR):
        call(walk, materials, spectra, walk_inputs(37, mk, CPU, seed=mk))
    d = stats.as_dict()
    assert d[walk_graph.EAGER] == 2.0
    assert d[f"{walk_graph.EAGER}: no CUDA"] == 2.0
    assert walk_graph.CAPTURES not in d and walk_graph.REPLAYS not in d
    assert len(walk_graph._CACHE.graphs) == 0


def test_a_kind_no_lane_has_runs_no_walk(fresh):
    materials, spectra = tables(CPU)
    inp = walk_inputs(16, layered.COATED_DIFFUSE, CPU, seed=0)
    inp["mat_id"] = torch.full_like(inp["mat_id"], 2)
    call("f", materials, spectra, inp)
    assert walk_graph.EAGER not in stats.as_dict()


def _literal(values, device):
    return torch.tensor(values, dtype=torch.float32, device=device)


def test_a_shared_constant_is_made_once_with_the_literal_values():
    a = config.const_f32((1.0, 1.0, -1.0), CPU)
    assert a is config.const_f32((1.0, 1.0, -1.0), CPU)
    assert a.dtype == torch.float32 and torch.equal(a, _literal([1.0, 1.0, -1.0], CPU))


def _directions(n, seed):
    g = torch.Generator().manual_seed(seed)
    w = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=-1)
    return w, torch.rand(n, 2, generator=g), torch.rand(n, generator=g)


@pytest.mark.parametrize("caller", ["diffuse_sample_f", "tr_sample_wm", "dielectric_sample"])
def test_the_shared_constants_give_the_literals_bits(monkeypatch, caller):
    """Each caller of a shared constant, against the same code with the
    constant made per call as before."""
    wo, u2, uc = _directions(513, seed=11)
    ax = torch.rand(513, generator=torch.Generator().manual_seed(3)) * 0.5

    def run():
        if caller == "diffuse_sample_f":
            s = bx.diffuse_sample_f(torch.rand(513, 4), wo, u2, uc)
        elif caller == "tr_sample_wm":
            return (sc.tr_sample_wm(wo, u2, ax, ax * 0.7),)
        else:
            # Half smooth lanes: the specular refraction reads _plus_z.
            s = cd.dielectric_sample(torch.full((513,), 1.5), wo, u2, uc,
                                     torch.where(uc < 0.5, 1e-4, ax), ax)
        return tuple(getattr(s, f.name) for f in dataclasses.fields(s))

    torch.manual_seed(5)
    shared = run()
    for mod in (bx, sc, cd):
        monkeypatch.setattr(mod, "const_f32", _literal)
    torch.manual_seed(5)
    literal = run()
    for a, b in zip(shared, literal):
        assert torch.equal(a, b)


class _Stub:
    """Stands in for the CUDA capture: records each capture and replays
    by calling the walk."""

    def __init__(self):
        self.captured = []

    def __call__(self, fn, args):
        self.captured.append(tuple(a.shape for a in args))
        return lambda new_args: fn(*new_args)


def _walk(x, y):
    return (x * 2.0 + y,)


def _table(rows=4):
    return torch.arange(rows, dtype=torch.float32)


def test_the_key_follows_lanes_walk_and_tables(fresh):
    stub = _Stub()
    cache = walk_graph.WalkGraphs(bound=8, capture=stub)
    table = _table()
    x, y = torch.ones(5), torch.ones(5)

    def run(name, n=5, tab=table):
        return cache.run(name, _walk, (x[:1].expand(n).clone(), y[:1].expand(n).clone()),
                         [tab, None])

    out = run(("f", 4, False))
    assert torch.equal(out[0], torch.full((5,), 3.0))
    run(("f", 4, False))
    assert len(stub.captured) == 1
    run(("f", 4, False), n=7)                     # another lane count
    run(("sample", 4, False))                     # another walk (its flags)
    run(("f", 4, True))                           # a layer medium
    rebuilt = _table()                            # a rebuilt table, same values
    run(("f", 4, False), tab=rebuilt)
    assert len(stub.captured) == 5 and len(cache.graphs) == 5
    d = stats.as_dict()
    assert d[walk_graph.CAPTURES] == 5.0 and d[walk_graph.REPLAYS] == 1.0
    assert walk_graph.EAGER not in d


def test_the_cache_holds_its_bound_then_runs_eagerly(fresh):
    stub = _Stub()
    cache = walk_graph.WalkGraphs(bound=2, capture=stub)
    table = _table()
    for n in (3, 4, 5, 3, 4):
        out = cache.run("f", _walk, (torch.ones(n), torch.zeros(n)), [table])
        assert torch.equal(out[0], torch.full((n,), 2.0))
    assert len(cache.graphs) == 2 and len(stub.captured) == 2
    d = stats.as_dict()
    assert d[walk_graph.CAPTURES] == 2.0
    assert d[walk_graph.REPLAYS] == 2.0
    assert d[walk_graph.EAGER] == 1.0 and d[f"{walk_graph.EAGER}: cache full"] == 1.0


def test_a_full_cache_forgets_the_graphs_of_tables_that_are_gone(fresh):
    stub = _Stub()
    cache = walk_graph.WalkGraphs(bound=1, capture=stub)
    old = _table()
    cache.run("f", _walk, (torch.ones(3), torch.ones(3)), [old])
    del old
    cache.run("f", _walk, (torch.ones(3), torch.ones(3)), [_table(5)])
    assert len(stub.captured) == 2 and len(cache.graphs) == 1
    assert walk_graph.EAGER not in stats.as_dict()
