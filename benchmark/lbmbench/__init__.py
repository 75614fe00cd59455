"""The benchmark of ``lbm_tpu_torch``: one cell of ``BENCHMARK.json`` run once.

Everything that belongs to one configuration, traffic mix, metric or cell
is a file of its own under ``benchmark/``, found by the name that
``BENCHMARK.json`` gives it (:mod:`lbmbench.spec`).  Nothing here imports
``jax``, ``jaxlib``, ``flax`` or ``lbm_tpu``; the program under test is
imported only by :mod:`lbmbench.harness`, after the card is found.
"""
