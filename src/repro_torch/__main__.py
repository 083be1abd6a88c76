"""``python -m repro_torch``: see :mod:`repro_torch.cli`."""

import sys

from repro_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
