#!/usr/bin/env python3
"""Wall time of `import paddle_tpu_torch` in fresh processes, tree by tree.

    python3 tools/port_import_time.py TREE [TREE ...] [--rounds N]

Each TREE is a checkout of this repository (for example a commit's `git
archive` unpacked into a directory that .gitignore lists). For each round
the trees are taken in turns, forward then backward (a b b a ...), and
each import runs in a new interpreter started in the tree, timed inside
it from before the import to after it: the cost a spawned DataLoader
worker pays before its first batch, less the interpreter's own start.
Prints one line an import and one summary line a tree (median, min, max).
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys

CODE = ("import time; t = time.perf_counter(); import paddle_tpu_torch; "
        "print(time.perf_counter() - t)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=3)
    opts = ap.parse_args()
    times = {t: [] for t in opts.trees}
    for r in range(opts.rounds):
        order = opts.trees if r % 2 == 0 else opts.trees[::-1]
        for tree in order:
            out = subprocess.run([sys.executable, "-c", CODE], cwd=tree,
                                 capture_output=True, text=True, timeout=300,
                                 check=True)
            s = float(out.stdout.strip().splitlines()[-1])
            times[tree].append(s)
            print("import %s round %d: %.3f s" % (tree, r, s), flush=True)
    for tree, ts in times.items():
        print("import %s: median %.3f s, min %.3f, max %.3f over %d"
              % (tree, statistics.median(ts), min(ts), max(ts), len(ts)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
