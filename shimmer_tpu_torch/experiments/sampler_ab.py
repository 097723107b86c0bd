"""ZSobol's kernels (csrc/sampler.cu) timed alone on the card against the
torch code they replace, at the diffuse cell's sampler: 1280x720, 16 spp,
one 921,600-lane pool.

For each call (``start_pixel_sample``, ``get_1d``, ``get_2d``) it times the
torch code (A, run on the card by patching ``samplers._on_card`` here) and
the kernel (B) in turns A B B A with CUDA events around a run of calls
(host time included: a call whose host work outlasts its kernel reads the
host), checks that both give the same tensors (``torch.equal``), reads the
kernel's own device time from torch.profiler's trace (warm, as repeated
calls leave their inputs in L2, and cold, L2 flushed before each call),
and sets that beside the kernel's bound: the larger of the instructions
one lane issues (SASS_INSTRUCTIONS) at the SM's issue rate (4 warp
instructions a clock) on every SM at the card's largest SM clock, and its
bytes at 3.35 TB/s.  Its share of the bound is taken over the cold time,
since a warm start reads its inputs from L2.  ``sass_as_counted`` says
whether the library on the card is the build those instructions were
counted from (its kernels' instruction counts in ``cuobjdump -sass``,
SASS_STATIC).

    python3 -m shimmer_tpu_torch.experiments.sampler_ab [--out chiprun_out/sampler_ab.json]

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from shimmer_tpu_torch import samplers
from shimmer_tpu_torch.measure import cuda_ms, nvidia_smi_line
from shimmer_tpu_torch.ops import cuda_build
from shimmer_tpu_torch.ops import sampler as zk

RES = (1280, 720)
SPP = 16
SEED = 3_000_000_019
HBM_BYTES_PER_S = 3.35e12
ISSUE_OPS_PER_CLOCK_PER_SM = 128  # 4 schedulers x 32 lanes a clock
REPS = {"A": 10, "B": 200}
L2_FLUSH_BYTES = 256 << 20       # five times the H100's 50 MB L2

# Instructions one lane issues, every SASS instruction on its path (loads,
# stores, branches and loop control included), counted by hand from
# `cuobjdump -sass` of the sm_90a build (nvcc of CUDA 12.8, -O3
# -fmad=false) for this sampler (log2_spp 4, so no last bit; 13 base-4
# digits; 26 Sobol' columns), one lane a thread.  A draw: six turns of the
# two-digit loop (98 each) and one digit (50); per dimension six turns of
# the four-column loop (26 each) and two columns (22); the rest (set-up,
# the seed's hash, scramble, conversion, stores) 116 for get_1d and 141
# for get_2d.  The start (a per-lane sample index): 153, its grid-stride
# loop's one-lane remainder taken once.
SASS_INSTRUCTIONS = {"start": 153, "get_1d": 932, "get_2d": 1135}
SAMPLER_COUNTED = {"log2_spp": 4, "n_base4_digits": 13, "index_bits": 26}
# The same build's instructions in each kernel, NOPs left out.
SASS_STATIC = {"start": 725, "get_1d": 339, "get_2d": 412}
SASS_KERNELS = {"start": "zsobol_start_kernel", "get_1d": "zsobol_draw_kernelILi1E",
                "get_2d": "zsobol_draw_kernelILi2E"}


def draw_bytes(width: int) -> int:
    return 8 + 8 + 8 + 4 * width   # morton, dim in; dim, width floats out


def start_bytes(pixel_bytes: int, si_bytes: int) -> int:
    return 2 * pixel_bytes + si_bytes + 3 * 8


@contextlib.contextmanager
def torch_code():
    """ZSobol's torch code on CUDA tensors while inside."""
    on_card = samplers._on_card
    samplers._on_card = lambda t: False
    try:
        yield
    finally:
        samplers._on_card = on_card


def inputs(dev):
    ys, xs = torch.meshgrid(torch.arange(RES[1]), torch.arange(RES[0]), indexing="ij")
    pixel_xy = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).to(dev, torch.int32)
    rng = np.random.default_rng(7)
    si = torch.from_numpy(rng.integers(0, SPP, pixel_xy.shape[0])).to(dev)
    dim = torch.from_numpy(rng.integers(0, 41, pixel_xy.shape[0])).to(dev)
    return pixel_xy, si, dim


def sass_static() -> dict | None:
    """Each kernel's instructions in ``cuobjdump -sass`` of the sampler
    library as built, NOPs left out; None without cuobjdump."""
    tool = Path(cuda_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(cuda_build.library_path("sampler"))],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    out = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name = body.split("\n", 1)[0]
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", body)
        for call, kernel in SASS_KERNELS.items():
            if kernel in name:
                out[call] = sum(1 for op in ops if not op.strip().startswith("NOP"))
    return out


def kernel_device_ms(fn, reps: int, flush=None) -> float:
    """Mean device time of the ZSobol kernels that ``reps`` calls of fn()
    launch, from torch.profiler's trace; ``flush`` (a tensor larger than
    the L2 cache) is zeroed before each call, so every call reads and
    writes device memory cold."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    ns = [e.duration_ns() for e in prof.profiler.kineto_results.events()
          if e.device_type() == torch.autograd.DeviceType.CUDA and "zsobol_" in e.name()]
    if len(ns) != reps:
        raise RuntimeError(f"{len(ns)} ZSobol kernels in the trace of {reps} calls")
    return sum(ns) / reps * 1e-6


def _tensors(result):
    """A start's state, or a draw's values and advanced dimension."""
    if isinstance(result, samplers.SamplerState):
        return [result.pixel_hash, result.sample_index, result.dim]
    return [result[0], result[1].dim]


def run() -> dict:
    dev = torch.device("cuda", 0)
    smp = samplers.ZSobolSampler(SPP, RES, SEED)
    pixel_xy, si, dim = inputs(dev)
    start = smp.start_pixel_sample(pixel_xy, si)
    state = samplers.SamplerState(start.pixel_hash, start.sample_index, dim)
    fields = {"log2_spp": smp.log2_spp, "n_base4_digits": smp.n_base4_digits,
              "index_bits": smp._index_bits}
    if fields != SAMPLER_COUNTED:
        raise ValueError(f"SASS_INSTRUCTIONS were counted at {SAMPLER_COUNTED}, not {fields}")
    calls = {
        "start": (lambda: smp.start_pixel_sample(pixel_xy, si), start_bytes(4, 8)),
        "get_1d": (lambda: smp.get_1d(state), draw_bytes(1)),
        "get_2d": (lambda: smp.get_2d(state), draw_bytes(2)),
    }
    n = pixel_xy.shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = float(nvidia_smi_line("clocks.max.sm", units=False))
    peak_ops = ISSUE_OPS_PER_CLOCK_PER_SM * sms * clock * 1e6
    static = sass_static()
    out = {"device": torch.cuda.get_device_name(dev), "nvidia_smi": nvidia_smi_line(),
           "lanes": n, "sms": sms, "max_sm_clock_mhz": clock, "peak_ops_per_s": peak_ops,
           "sampler": {"spp": SPP, "resolution": RES, **fields},
           "sass_static": static, "sass_as_counted": static == SASS_STATIC, "calls": {}}
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    for name, (fn, nbytes) in calls.items():
        ops = SASS_INSTRUCTIONS[name]
        zk.reset_launches()
        kernel = fn()
        launches = zk.launch_counts()
        with torch_code():
            plain = fn()
        pairs = [(a, b.expand_as(a)) for a, b in zip(_tensors(kernel), _tensors(plain))]
        same = all(torch.equal(a, b) for a, b in pairs)
        err = max(float((a.double() - b.double()).abs().max()) for a, b in pairs)
        times = {}
        for label in ("A1", "B1", "B2", "A2"):
            ctx = torch_code() if label[0] == "A" else contextlib.nullcontext()
            with ctx:
                times[label] = cuda_ms(fn, REPS[label[0]])
        by_ops, by_bytes = n * ops / peak_ops * 1e3, n * nbytes / HBM_BYTES_PER_S * 1e3
        kernel_ms = kernel_device_ms(fn, REPS["B"])
        cold_ms = kernel_device_ms(fn, REPS["B"], flush)
        bound_ms = max(by_ops, by_bytes)
        out["calls"][name] = {
            "same_output": same, "max_abs_err": err, "launches": launches, "ms": times,
            "torch_ms": (times["A1"] + times["A2"]) / 2,
            "kernel_call_ms": (times["B1"] + times["B2"]) / 2, "kernel_ms": kernel_ms,
            "kernel_cold_ms": cold_ms,
            "instructions_per_lane": ops, "bytes_per_lane": nbytes, "bound_ms_ops": by_ops,
            "bound_ms_bytes": by_bytes, "bound_ms": bound_ms,
            "bound_by": "instructions" if by_ops >= by_bytes else "bytes",
            "share_of_bound": bound_ms / cold_ms,
        }
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/sampler_ab.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("sampler_ab needs a CUDA card; none is available")
    res = run()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
