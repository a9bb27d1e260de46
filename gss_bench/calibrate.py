"""Readings that the limits of ``correct`` are set from: the program's
numbers and the control's, seed by seed, at a cell's own size and load.

    python -m gss_bench.calibrate --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

Each seed is one run of the cell (``python -m gss_bench.run``), whose
check also enhances its sample with the control, the reference computed
in TF32 (``gss_bench/reference/chain.py``), and prints a ``calibration``
line on standard error with both sets of numbers.  The benchmark's own
runs never run the control.
"""

import argparse
import sys

from gss_bench import run


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--seeds', type=int, nargs='+', required=True)
    args = parser.parse_args(argv)
    status = 0
    for seed in args.seeds:
        status |= run.main(['--workload', args.workload, '--seed', str(seed),
                            '--seconds', str(args.seconds), '--trace', '0'],
                           control=True)
    return status


if __name__ == '__main__':
    sys.exit(main())
