"""CLI entry: ``python -m bachelors_tpu_torch config.ini [more.ini ...]
[--set sec.key=val] [--device cuda|cpu]``."""
import sys

from .app.driver import main

if __name__ == "__main__":
    sys.exit(main())
