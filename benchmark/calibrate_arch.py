"""`benchmark.calibrate` for the cells of traffic kind `train_arch`: the
same readings, arguments and output, with that kind's session.

    python3 -m benchmark.calibrate_arch --workload <train_arch cell> --read program=1,2,3 --read control=4,5,6
        [--read <fault>=7,8,9 ...] [--read fp32=10] [--out FILE]
"""

from __future__ import annotations

import sys

from . import calibrate
from .kinds import train_arch


def main(argv=None) -> int:
    with train_arch.sessions():
        return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())
