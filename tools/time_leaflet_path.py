#!/usr/bin/env python3
"""Time one leaflet configuration through FSI.run with a checkout's own
code, on one CUDA GPU, to compare two versions of the port inside one call.

    python3 tools/time_leaflet_path.py --root DIR [--config fsi_leaflet_r2]
                                       [--steps 4] [--label NAME]

Imports DIR's chip_smoke.py and openifem_tpu_torch (DIR: a checkout, for
the parent one unpacked with `git archive`), builds DIR's kernel and runs
DIR's chip_smoke._full_run, which prints each step and the summary line
with the median ms per coupled step and the Krylov counts.  Run parent,
change, change, parent in one call: the host is shared and times of
separate calls do not compare.
"""

import argparse
import os
import sys
import tempfile


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--config", default="fsi_leaflet_r2",
                    choices=("element", "fsi_leaflet", "fsi_leaflet_r2"))
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs
    import openifem_tpu_torch
    assert openifem_tpu_torch.__file__.startswith(root + os.sep)
    cs.phase1_build()
    # the solid writes its first-step VTU output to the working directory
    with tempfile.TemporaryDirectory(prefix="time_leaflet_") as work:
        os.chdir(work)
        cs._full_run(torch, args.label or os.path.basename(root),
                     args.config, args.steps)
        os.chdir(root)


if __name__ == "__main__":
    main()
