"""Packet-step micro-benchmarks: the port's counterpart of the reference's
packet-step experiments, run through the hand-written kernels of
``ops/packet_step.py`` at the reference scripts' own sizes.

    python -m shimmer_tpu_torch.experiments.packet_step     # on the CUDA card

Cases, by kernel-table row (PERF.md) and the reference script they mirror
(R = 16384 rows, one packet of P = 128 rays):

* 10 (``experiments/exp_scaling.py``): the slab chase over the transposed
  table (fetch A) at 16,384, 131,072 and 1,048,576 steps; ns per step of
  each and the marginal between consecutive counts;
* 11 (``exp_packet_step.py``): the same with row 11's stack store, 512
  steps;
* 12 (``exp_packet_step2.py``): fetch A (transposed table) and B/C/D (one
  function over the row table on Hopper), 512 steps;
* 13 (``exp_fetch_honest.py``): ``empty`` (the chase alone), A and B/C/D,
  marginal between 16,384 and 262,144 steps;
* 14 (``exp_loop_overhead.py``): bodies k1-k6, 16,384 steps;
* 15 (``exp_step_attrib.py``): the six step-attribution variants, G = 64
  programs of K = 2 packets, 256 steps, over the bench scene's BVH8
  (300,000 sphere triangles, as its ``main``); ns per packet-step;
* 16 (``exp_ablate_step.py``): v0-v4, G = 64, marginal between 256 and
  2,048 steps divided by G, as the reference divides it; each case also
  reports its chain's shape (``mu``, ``lam``, ``distinct`` rows).

On the card the slab chase runs split (ops/packet_step.py): its ns per
step is the chain walk's latency plus the slab tests spread over the card,
not one packet's step latency; the slab and slab_stack cases also time
the chain alone (the ``empty`` body on the same inputs and steps,
``chain_ms``).  Row 15 runs one block per program's packet, side by
side: its ns per packet-step is the launch's time over G * K * steps, not
one packet's step latency; its cases also time the chain alone (the
visits computed in closed form, ``ops.packet_step.step_attrib_chain``).
Row 16's programs share one computation on the card (a walk to the
chain's cycle, then the sums in step order): its ns per step measures
that, not one program's step latency.

Inputs come from ``numpy.random.default_rng(SEED)`` drawn in each script's
own order, so they are the reference's arrays.  The reference's
memoization and host-transfer probes (exp_scaling.py:71-112) time its TPU
tunnel, not a kernel, and have no counterpart.  Each case runs the kernel
and its plain version on the same tensors at every step count and
compares them bit for bit (row 15: the output and the carried stacks).
With ``device="cpu"`` the wrappers run the plain versions and the times
are host-clock times of the CPU, not of a card.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from shimmer_tpu_torch.bench_scene import BENCH_TRIS, build_bench_scene
from shimmer_tpu_torch.config import resolve_device
from shimmer_tpu_torch.experiments.gather import time_ms
from shimmer_tpu_torch.ops import packet_step as ps

SEED = 0
R = 16384
# Row 15's grid and packets (exp_step_attrib.py:32-33, 199) and row 16's
# grid (exp_ablate_step.py:20).
ATTRIB_PROGRAMS, ATTRIB_PACKETS, ABLATE_PROGRAMS = 64, 2, 64
# Timed launches of a kernel per step count, after one warm-up.
REPS = 3
# Float operations a lane does per step, for the bound (comparisons
# count as operations): the packet slab test of one box is 6 subtractions,
# 6 multiplies, 10 min / max, 2 comparisons and an and (25), plus 8 adds
# for the hit count and 1 into acc; row 15's box adds the 1.0001 slack
# and the t_best test (26, as chip_smoke.py counts a traversal visit) and
# a watertight triangle costs 65 (9 subtractions, 12 for the shear, 21 for
# the three error-compensated edge products, 16 comparisons and sums for
# the sign and scaled-distance tests, a division and a multiply); row 16's
# slab term of one slot and lane is 17 (4 subtractions, 4 multiplies, 6
# min / max, the 1.0001 slack, a comparison and the field-48 and).
SLAB_OPS = 8 * 25 + 9
ATTRIB_BOX_OPS, ATTRIB_TRIANGLE_OPS = 26, 65
ABLATE_SLOT_OPS = 17
# The bound's rates: the H100 SXM's HBM and non-tensor-core float32 peak
# (NVIDIA's data sheet), as chip_smoke.py uses them.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


@dataclasses.dataclass(frozen=True)
class Case:
    row: str            # kernel-table row
    label: str          # the reference script's name for the case
    kernel: str         # ps.KERNELS
    variant: str        # ps.BODIES, ps.ATTRIB_VARIANTS, or v0-v4 (step_ablate)
    steps: tuple        # the step counts timed
    transposed: bool = False
    n_rows: int = R
    programs: int = 1   # G (step_attrib, step_ablate)

    @property
    def name(self) -> str:
        layout = " transposed" if self.transposed and self.variant.startswith("slab") else ""
        return f"{self.row} {self.label} {self.kernel}/{self.variant}{layout}"


def cases() -> list[Case]:
    """The reference scripts' cases, at their own sizes."""
    chase = "packet_slab_chase"
    out = [Case("10", "make", chase, "slab", (16384, 131072, 1048576), True),
           Case("11", "step_kernel", chase, "slab_stack", (512,), True),
           Case("12", "A roll", chase, "slab", (512,), True),
           Case("12", "B mxu/C xpose/D scalar", chase, "slab", (512,))]
    for label, body, transposed in (("empty", "empty", False), ("A roll", "slab", True),
                                    ("B mxu/C xpose/D scalar", "slab", False)):
        out.append(Case("13", label, chase, body, (16384, 262144), transposed))
    # Row 14's kernels all take the transposed table; k1-k4 never read it.
    for label, body in (("k1 empty while", "int_sum"), ("k2 smem chase while", "chase"),
                        ("k3 vec acc while", "acc"), ("k4 vec acc fori", "acc_scaled"),
                        ("k5 fetch+slab fori", "slab_fixed"), ("k6 fetch+slab while", "slab")):
        out.append(Case("14", label, chase, body, (16384,), True))
    for variant in ps.ATTRIB_VARIANTS:
        out.append(Case("15", variant, "step_attrib", variant, (256,), programs=ATTRIB_PROGRAMS))
    for v in range(ps.ABLATE_VARIANTS):
        out.append(Case("16", f"v{v}", "step_ablate", f"v{v}", (256, 2048),
                        programs=ABLATE_PROGRAMS))
    return out


def make_inputs(case: Case, device, tables=None) -> dict:
    """A case's tensors on ``device``, drawn as its reference script draws
    them.  Row 15 takes ``tables`` = (rows8, meta, stack_depth) of a BVH8
    scene."""
    rng = np.random.default_rng(SEED)
    n = case.n_rows
    P = ps.LANES

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    if case.kernel == "step_attrib":
        rows8, meta, stack_depth = tables
        rays = rng.standard_normal((case.programs * ATTRIB_PACKETS, 16, P)).astype(np.float32)
        return {"rows8": rows8.to(device), "meta": meta.to(device), "rays": t(rays),
                "stack_size": int(stack_depth) + 8}
    if case.kernel == "step_ablate":
        tab_f = rng.normal(size=(n, 128)).astype(np.float32)
        nxt = rng.integers(0, n, size=(n,), dtype=np.int32)
        tab = t(tab_f)
        return {"meta": t(nxt), "tab": tab, "tab_i": ps.pack_bf16_hilo(tab)}
    if case.row in ("12", "13"):
        tab_rows = rng.normal(size=(n, 128)).astype(np.float32)
        table = tab_rows.T if case.transposed else tab_rows
    else:
        table = rng.normal(size=(128, n)).astype(np.float32)
    nxt = rng.integers(0, n, size=(n,), dtype=np.int32)
    rays = rng.normal(size=(8, P)).astype(np.float32)
    return {"table": t(table), "nxt": t(nxt), "rays": t(rays)}


def _functions(case: Case, x: dict):
    """(kernel(steps), plain(steps, stats)) of a case; each returns a tuple
    of output tensors."""
    if case.kernel == "packet_slab_chase":
        args = (x["table"], x["nxt"], x["rays"])
        return (lambda s: (ps.packet_slab_chase(*args, s, case.variant, case.transposed),),
                lambda s, st: (ps.packet_slab_chase_plain(*args, s, case.variant, case.transposed,
                                                          stats=st),))
    if case.kernel == "step_attrib":
        args = (x["rows8"], x["meta"], x["rays"], case.variant)
        size = x["stack_size"]
        init = torch.full((ATTRIB_PACKETS, size), ps.INT32_MIN, dtype=torch.int32,
                          device=x["rays"].device)
        return (lambda s: ps.step_attrib(*args, s, ATTRIB_PACKETS, size, init),
                lambda s, st: ps.step_attrib_plain(*args, s, ATTRIB_PACKETS, size, init,
                                                   stats=st))
    v = int(case.variant[1:])
    args = (x["meta"], x["tab"], x["tab_i"], v)
    return (lambda s: (ps.step_ablate(*args, s, case.programs),),
            lambda s, st: (ps.step_ablate_plain(*args, s, case.programs, stats=st),))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def work(case: Case, steps: int, stats: dict, x: dict) -> tuple[int, int]:
    """(bytes, float operations) the case's function needs at ``steps``
    steps on these inputs: each input byte it reads once (the rows, nxt
    and meta words this run's chain reads, by the columns the step uses),
    each output byte once; operations as SLAB_OPS and the others count
    them, for the slots and steps this run's data takes.  A slab chase
    needs each distinct row's slab test once per lane, times its visits
    (one multiply more), as the plain version and the kernel compute it."""
    P = ps.LANES
    if case.kernel == "packet_slab_chase":
        body = case.variant
        nbytes = stats["rows_read"] * ps.BOX_FLOATS * 4 + stats["nxt_read"] * 4 + 4 * P
        if body in ("acc", "acc_scaled"):
            return nbytes + 4 * P, steps * P * (1 if body == "acc" else 2)
        if body in ("empty", "chase", "int_sum"):
            return nbytes, steps if body == "int_sum" else 0
        return nbytes + 6 * 4 * P, stats["rows_read"] * P * (SLAB_OPS + 1)
    n_prog = case.programs
    if case.kernel == "step_attrib":
        n_packets = n_prog * ATTRIB_PACKETS
        nbytes = (stats["rows_read"] * 80 * 4 + stats["meta_read"] * 4
                  + n_packets * (ps.ATTRIB_RAY_ROWS + ps.ATTRIB_OUT_ROWS) * P * 4
                  + 2 * ATTRIB_PACKETS * x["stack_size"] * 4)
        box = 0 if case.variant in ("noint", "nobits", "noscalar") else 8 * ATTRIB_BOX_OPS
        leaf = 0 if case.variant == "noleaf" else stats["leaf_slots"] * ATTRIB_TRIANGLE_OPS
        return nbytes, P * (n_packets * steps * box + leaf)
    # Row 16: the G programs are equal, so the function needs one
    # program's work and G output blocks.  Its operations: the terms of
    # the distinct rows (a slab row's 8 slots for each lane; a leaf row's 8
    # products, the same for every lane; v1's terms are table values) and
    # the adds in step order, one a step and accumulator (v2: two; v0's
    # sum of ones has a closed form and needs none).
    v = int(case.variant[1:])
    adds = (0 if v == 0 else 2 if v == 2 else 1) * 8 * P * steps
    terms = stats["slab_rows"] * P * 8 * ABLATE_SLOT_OPS + stats["leaf_rows"] * 8
    nbytes = stats["bytes_read"] + stats["meta_read"] * 4 + n_prog * 8 * P * 4
    return nbytes, adds + terms


def bound(nbytes: int, ops: int) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / FP32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _chain(case: Case, x: dict):
    """The chain alone of a case, (its kernel's launch-count name,
    kernel(steps), plain(steps)), or None: for the slab chases that walk
    one before their slab tests the ``empty`` body on the same inputs, for
    row 15 its visits (step_attrib_chain)."""
    if case.kernel == "packet_slab_chase" and case.variant in ("slab", "slab_stack"):
        args = (x["table"], x["nxt"], x["rays"])
        return ("packet_slab_chase",
                lambda s: ps.packet_slab_chase(*args, s, "empty", case.transposed),
                lambda s: ps.packet_slab_chase_plain(*args, s, "empty", case.transposed))
    if case.kernel == "step_attrib":
        size = x["stack_size"]
        init = torch.full((ATTRIB_PACKETS, size), ps.INT32_MIN, dtype=torch.int32,
                          device=x["rays"].device)
        return ("step_attrib_chain",
                lambda s: ps.step_attrib_chain(x["rows8"], x["meta"], x["rays"], case.variant, s,
                                               ATTRIB_PACKETS, size, init),
                lambda s: ps.step_attrib_chain_plain(x["meta"], case.variant, case.programs,
                                                     ATTRIB_PACKETS, s, size, init))
    return None


def chain_work(case: Case, steps: int, stats: dict, x: dict) -> int:
    """Bytes row 15's chain alone needs (its meta words read, the stacks'
    slot 1 and the visits written); it does no float operations."""
    n_packets = case.programs * ATTRIB_PACKETS
    return stats["meta_read"] * 4 + ATTRIB_PACKETS * 4 + n_packets * steps * 8


def run_case(case: Case, x: dict) -> dict:
    """Run one case: at each step count the kernel against its plain
    version on the same tensors (bit for bit), both timed, and the work
    the bound counts; then ns per step as the reference reports it, and
    the chain alone's time where the case has one (``chain_ms``, its kernel
    held against its plain version too).  ``launches`` counts the kernel's
    timed launches (the warm-up and REPS, the chain alone's included where
    it is the same kernel), ``chain_launches`` the chain alone's, neither
    the ones compared with the plain version."""
    dev = next(iter(v for v in x.values() if isinstance(v, torch.Tensor))).device
    kernel, plain = _functions(case, x)
    chain = _chain(case, x)
    launches = chain_launches = 0
    per = {}
    for s in case.steps:
        got = kernel(s)
        stats = {}
        _sync(dev)
        t0 = time.perf_counter()
        want = plain(s, stats)
        _sync(dev)
        plain_ms = (time.perf_counter() - t0) * 1e3
        ok = all(torch.equal(a, b) for a, b in zip(got, want))
        err = float((got[0] - want[0]).abs().max())
        if chain is not None:
            chain_got = chain[1](s)
            _sync(dev)
            t0 = time.perf_counter()
            chain_want = chain[2](s)
            _sync(dev)
            chain_plain_ms = (time.perf_counter() - t0) * 1e3
            ok = ok and torch.equal(chain_got, chain_want)
        before = ps.launch_counts()
        ms = time_ms(lambda: kernel(s), dev, reps=REPS)
        chain_ms = None if chain is None else time_ms(lambda: chain[1](s), dev, reps=REPS)
        after = ps.launch_counts()
        launches += after[case.kernel] - before[case.kernel]
        if chain is not None and chain[0] != case.kernel:
            chain_launches += after[chain[0]] - before[chain[0]]
        nbytes, ops = work(case, s, stats, x)
        per[s] = {"ms": ms, "plain_ms": plain_ms, "ok": ok, "max_abs_err": err,
                  "checksum": float(got[0].double().sum()), "bytes": nbytes, "ops": ops,
                  **bound(nbytes, ops)}
        if case.kernel == "step_ablate":
            per[s].update({k: stats[k] for k in ("mu", "lam", "distinct")})
        if chain_ms is not None:
            per[s]["chain_ms"] = chain_ms
            per[s]["chain_plain_ms"] = chain_plain_ms
            if case.kernel == "step_attrib":
                per[s]["chain_bound_ms"] = bound(chain_work(case, s, stats, x), 0)["bound_ms"]
    last = case.steps[-1]
    res = {"name": case.name, "row": case.row, "kernel": case.kernel, "variant": case.variant,
           "steps": per, "ok": all(p["ok"] for p in per.values()),
           "max_abs_err": max(p["max_abs_err"] for p in per.values()),
           "launches": launches,
           **{k: per[last][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "bytes", "ops",
                                        "chain_ms", "chain_plain_ms", "chain_bound_ms", "mu",
                                        "lam", "distinct")
              if k in per[last]}}
    if chain is not None:
        res["chain_kernel"] = chain[0]
        res["chain_launches"] = chain_launches
    if case.kernel == "step_attrib":
        n_steps = case.programs * last * ATTRIB_PACKETS
        res["ns_per_step"] = per[last]["ms"] * 1e6 / n_steps  # per packet-step
    elif len(case.steps) > 1:
        lo, hi = case.steps[-2], case.steps[-1]
        marg = (per[hi]["ms"] - per[lo]["ms"]) * 1e6 / (hi - lo)
        if case.kernel == "step_ablate":
            res["ns_per_step_per_program"] = marg
            marg /= case.programs  # the reference's division by its sequential grid
        res["ns_per_step"] = marg
        if case.row == "10":
            res["marginal_ns"] = [(per[b]["ms"] - per[a]["ms"]) * 1e6 / (b - a)
                                  for a, b in zip(case.steps, case.steps[1:])]
    else:
        res["ns_per_step"] = per[last]["ms"] * 1e6 / last
    return res


def format_line(res: dict) -> str:
    times = ", ".join(f"{s}: {p['ms']:.4f} ms ({p['ms'] * 1e6 / s:.2f} ns/step"
                      + (f", chain alone {p['chain_ms']:.4f} ms" if "chain_ms" in p else "") + ")"
                      for s, p in res["steps"].items())
    exact = "exact" if res["ok"] else f"MISMATCH max|d|={res['max_abs_err']:g}"
    extra = ""
    if "marginal_ns" in res:
        extra = " marginals " + ", ".join(f"{m:.2f}" for m in res["marginal_ns"]) + " ns/step;"
    unit = "ns/packet-step" if res["kernel"] == "step_attrib" else "ns/step"
    if "mu" in res:
        extra += f" chain mu {res['mu']} lambda {res['lam']} distinct {res['distinct']};"
    return (f"  {res['name']:58s}: {res['ns_per_step']:10.3f} {unit};{extra} {times}; "
            f"plain {res['plain_ms']:.1f} ms; {exact}")


def bench_tables(device) -> tuple:
    """(rows8, meta, stack_depth) of the bench scene that row 15 runs on."""
    scene, _, _ = build_bench_scene(BENCH_TRIS, device=device)
    tris = scene.triangles
    return tris.rows8, tris.meta, tris.stack_depth


def main(device=None, tables=None) -> dict:
    """Run every case on ``device`` (default: the CUDA card; raises without
    one) and return {case name: result}.  Row 15 runs on ``tables`` =
    (rows8, meta, stack_depth), by default the bench scene built here."""
    dev = resolve_device(device)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else f"{dev} (plain torch versions, host clock)")
    print(f"packet-step micro-benchmarks on {where}, seed {SEED}", flush=True)
    if tables is None:
        tables = bench_tables(dev)
    rows = {}
    for case in cases():
        res = run_case(case, make_inputs(case, dev, tables))
        print(format_line(res), flush=True)
        rows[case.name] = res
    return rows


if __name__ == "__main__":
    sys.exit(0 if all(r["ok"] for r in main().values()) else 1)
