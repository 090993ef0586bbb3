"""Command-line tools around the port: the dense- and sparse-model
converters and the serving front end's load generator.

    python -m hugectr_backend_tpu_torch.tools.convert_dense_model model.pt out/1
    python -m hugectr_backend_tpu_torch.tools.convert_sparse_model ckpt.pt out/
    python -m hugectr_backend_tpu_torch.tools.perf_client --url http://127.0.0.1:8000
"""
