"""CLI: run a Dedalus protocol through the fault injector, emit Molly output.

    python -m nemo_tpu_torch.dedalus -program specs/pb_asynchronous.ded \
        -EOT 6 -EFF 4 -crashes 0 -o out/
    python -m nemo_tpu_torch.dedalus -spec pb_asynchronous -o out/   # bundled spec

Flag names mirror the Molly invocations recorded in the reference's
case-study headers (e.g. case-studies/pb_asynchronous.ded:2: --EOT 6
--EFF 4 --crashes 1 --nodes C,a,b,c).  The output directory feeds straight
into the debugger: python -m nemo_tpu_torch.cli -faultInjOut <out>/<name>
--graph-backend python (or --device cpu|cuda).
"""

from __future__ import annotations

import argparse
import os
import sys

from nemo_tpu_torch.dedalus.faults import FaultSpec, write_molly_output
from nemo_tpu_torch.dedalus.parser import load_program
from nemo_tpu_torch.dedalus.registry import BUNDLED_SPECS, bundled_spec_path


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m nemo_tpu_torch.dedalus", description="Mini-Dedalus fault injector (Molly stand-in)."
    )
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("-program", "--program", help="path to a .ded protocol spec")
    src.add_argument(
        "-spec",
        "--spec",
        choices=sorted(BUNDLED_SPECS),
        help="a bundled case-study spec (uses its recorded EOT/EFF/crashes "
        "defaults unless overridden)",
    )
    parser.add_argument("-EOT", "--eot", type=int, default=None, help="end of time (horizon)")
    parser.add_argument("-EFF", "--eff", type=int, default=None, help="end of finite failures")
    parser.add_argument("-crashes", "--crashes", type=int, default=None, help="max crashes")
    parser.add_argument("-o", "--out", default=".", help="output root directory")
    parser.add_argument(
        "-max-runs", "--max-runs", type=int, default=64, help="fault-run enumeration cap"
    )
    args = parser.parse_args(argv)

    if args.spec:
        path = bundled_spec_path(args.spec)
        defaults = BUNDLED_SPECS[args.spec]
        name = args.spec
    else:
        path = args.program
        defaults = FaultSpec()
        name = os.path.splitext(os.path.basename(path))[0]

    spec = FaultSpec(
        eot=args.eot if args.eot is not None else defaults.eot,
        eff=args.eff if args.eff is not None else defaults.eff,
        max_crashes=args.crashes if args.crashes is not None else defaults.max_crashes,
        max_runs=args.max_runs,
    )
    corpus = write_molly_output(load_program(path), spec, args.out, name)
    print(f"Molly-format output written to: {corpus}")  # lint: allow-print (the CLI's one line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
