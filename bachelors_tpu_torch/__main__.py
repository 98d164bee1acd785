"""CLI entry: ``python -m bachelors_tpu_torch config.ini [more.ini ...]
[--set sec.key=val] [--device cuda|cpu]``.

Every rank of a multi-process run starts here too: ``python -m
bachelors_tpu_torch.launch -n N ...`` spawns N of them (the BTPU_*
variables), and torchrun starts each with ``--set tpu.multihost=true``."""
import sys

from .app.driver import main

if __name__ == "__main__":
    sys.exit(main())
