"""Serving over several GPUs: the process bootstrap, the dp × mp mesh of
ranks and the row-sharded doc store with its local-top-R + all_gather
re-rank, mirroring ``gdr_tpu/parallel/``."""
