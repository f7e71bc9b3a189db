"""The benchmark of agplace_tpu_torch on NVIDIA H100 cards (``run.py``)."""
