"""Row and 2-D sharding of the grid (the port of ``lbm_tpu.parallel``)."""
