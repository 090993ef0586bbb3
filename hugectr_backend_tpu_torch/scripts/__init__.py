"""The port's scripts, each run as
``python -m hugectr_backend_tpu_torch.scripts.<name>``: the lookup
microbenchmarks, the A/B timers, ``frontend_saturation`` (the front end's
software with the device stubbed out) and ``auc_parity``; ``ci.sh`` runs
the port's whole CI pass."""
