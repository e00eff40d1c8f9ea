"""The control of the output check at a cell's own size: for each seed,
a whole run of the cell whose EM answers are replaced, once the window
has closed, by the plain reference's EM in float32 (harness/control.py).
Each run's result line is printed with the control's em_gap; the check
has to call every one incorrect.

  python3 port_bench/control.py --workload kir-rna.candidates \\
      --seeds 11 12 13 --seconds 20
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import run  # noqa: E402
from harness.control import f32_answer  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    failed_as_it_should = 0
    for seed in args.seeds:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = run.main(["--workload", args.workload, "--seed", str(seed),
                           "--seconds", str(args.seconds), "--trace", "0"],
                          em_answer=f32_answer)
        lines = out.getvalue().splitlines()
        result = json.loads(lines[-1]) if rc == 0 and lines else None
        print(json.dumps({"seed": seed, "rc": rc, "result": result}),
              flush=True)
        if result is not None and result["correct"] is False:
            failed_as_it_should += 1
    print(f"control: {failed_as_it_should} of {len(args.seeds)} runs "
          "judged incorrect", flush=True)
    return 0 if failed_as_it_should == len(args.seeds) else 1


if __name__ == "__main__":
    raise SystemExit(main())
