"""``python -m tpusparse_torch``: the command line (``cli.py``)."""

import sys

from tpusparse_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
