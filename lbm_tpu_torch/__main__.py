"""``python -m lbm_tpu_torch`` runs the CLI."""

import sys

from lbm_tpu_torch.cli import main

sys.exit(main())
