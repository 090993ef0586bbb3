"""Lookup microbenchmarks of the port, each run as
``python -m hugectr_backend_tpu_torch.scripts.<name>``."""
