"""The port's scripts, each run as
``python -m hugectr_backend_tpu_torch.scripts.<name>``: the
microbenchmarks (lookup, dense, interaction, w8a8, int4, overhead, update
storm, scaling), the A/B timers, ``frontend_saturation`` (the front end's
software with the device stubbed out) and ``auc_parity``; ``ci.sh`` runs
the port's whole CI pass."""
