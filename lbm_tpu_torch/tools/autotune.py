"""Measure the temporal kernels' (BY, BX, K) candidates on the card and
record the winners in the tuning cache (``lbm_tpu_torch/tuning_cache.json``
or ``$LBM_TUNING_CACHE``, see :mod:`lbm_tpu_torch.tuning`).  The port of
``tools/autotune.py``: after ``python -m lbm_tpu_torch.tools.autotune
--grid 1536x1536``, every run of that grid on the same kind of card takes
the measured-best tile instead of the fixed order.

    python -m lbm_tpu_torch.tools.autotune --case 1024x1024
    python -m lbm_tpu_torch.tools.autotune --grid 1536x1536 [--steps 960] [--repeats 3]
    python -m lbm_tpu_torch.tools.autotune --case 1024x1024 --dry-run  # print only

A thin wrapper over :func:`lbm_tpu_torch.tuning.autotune_sweep` (also
``python -m lbm_tpu_torch.cli autotune``).
"""

from __future__ import annotations

import sys

from lbm_tpu_torch.cli import cmd_autotune_main
from lbm_tpu_torch.tuning import temporal_candidates as candidates  # noqa: F401


def main(argv=None) -> int:
    return cmd_autotune_main(argv)


if __name__ == "__main__":
    sys.exit(main())
