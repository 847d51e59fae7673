"""The control of a cell: the reference in the program's place, one guarantee broken.

    python3 -m benchmark.control --workload <cell> --seeds <n> [<n> ...] [--epochs 2]

Each driver's `Control` stands in for the program: the plain reference,
computed with one guarantee of the configuration broken (drivers/rs.py:
the parity rows the quorum does not read left out; drivers/tpke.py: t
shares combined where t + 1 are due).  It runs through the harness at the
cell's own size (inputs, window of `--epochs` epochs, comparison) and
prints, for each seed, the numbers compared with their limits: the
control must come out not correct.  It needs no card; the benchmark's own
runs never run it.
"""
from __future__ import annotations

import argparse
import json

from .run import cell_parts, load_module, load_spec, run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--epochs", type=int, default=2)
    args = ap.parse_args(argv)
    _, config, _ = cell_parts(load_spec(), args.workload)
    control = load_module("drivers", config["driver"]).Control
    all_failed = True
    for seed in args.seeds:
        r = run_cell(args.workload, seed, 1e9, False, device="cpu",
                     max_epochs=args.epochs, system=control)
        all_failed &= not r["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": r["correct"],
                          "checks": r["checks"]}), flush=True)
    return 0 if all_failed else 1


if __name__ == "__main__":
    raise SystemExit(main())
