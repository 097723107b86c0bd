"""The readings a cell's limits are set from, at the cell's own size, on
the seeds given: the control (the plain reference put in the program's
place at a lower precision, or with a planted fault) against the
reference at the configuration's precision, or the program's own answer
where its loop makes the checked answer in set-up.  The benchmark's runs
do not run it.

    python benchmark/control.py --workload <cell> --seeds <n> [<n> ...] \\
        --variant tf32|bf16|half|altered|program

``bf16`` rounds each sample's spectral radiance to bfloat16 before the
film; ``tf32`` lets float32 matrix products run in TF32.  The loop kind
of the cell's traffic says which variants it has (its ``control``).
Prints one JSON line per seed: the numbers the cell's check compares,
beside their limits.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402

VARIANTS = ("bf16", "tf32", "half", "altered", "program")


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variant", choices=VARIANTS, required=True)
    args = p.parse_args(argv)
    cell, config, traffic = harness.load_cell(harness.load_bench(), args.workload)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card; none found", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    loop = harness.module("loops", traffic["kind"])
    for seed in args.seeds:
        numbers = loop.control(config, traffic, seed, args.variant, "cuda")
        print(json.dumps({"workload": args.workload, "variant": args.variant, "seed": seed,
                          "compared": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    os.environ["USE_FLAX"] = "0"
    sys.exit(main(sys.argv[1:]))
