"""`python -m metaeuk_tpu_torch ARGS` runs the metaeuk-tpu-torch CLI."""

import sys

from .cli import main

sys.exit(main())
