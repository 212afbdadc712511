"""``python -m phoskintime_tpu_torch <command>``: the command-line interface."""

import sys

from phoskintime_tpu_torch.cli import main

main(sys.argv[1:])
