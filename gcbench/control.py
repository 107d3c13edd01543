"""The control of a cell's correctness check: the same run as
gcbench/run.py, with the configuration's "control" switch applied to the
program's parameters (a shortcut of the program's own that a faster but
worse change could take, such as skipping the bubble repair).  Its check
has to come out not correct.

  python3 gcbench/control.py --workload CELL --seed N --seconds S
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gcbench import run  # noqa: E402

if __name__ == "__main__":
    sys.exit(run.main(sys.argv[1:], control=True))
