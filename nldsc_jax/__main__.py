"""``python -m nldsc_jax`` — CLI entry (reference ran ``python nldsc``)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
