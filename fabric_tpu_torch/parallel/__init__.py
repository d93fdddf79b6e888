"""Host-side parallelism of the port (counterpart: ``fabric_tpu/parallel/``):
the host staging pool (``hostpool.py``)."""
