"""`python -m twopaco_tpu_torch`: the twopaco CLI (cli/twopaco.py)."""

import sys

from twopaco_tpu_torch.cli.twopaco import main

if __name__ == "__main__":
    sys.exit(main())
