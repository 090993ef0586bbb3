"""The nine examples of the JAX package's ``examples/``, on the port.

Each is a module with ``main(device=None, root=None, state=None) -> dict``
that prints what its JAX twin prints and returns those values; its checks
raise. They run on the card unless ``device="cpu"`` (``--device cpu``);
without a card and without that, they raise. ``root`` is the directory the
example writes its tables into (a temporary one by default); ``state`` holds
state dicts for its models (Flax's initialisation from a seeded generator by
default). The module names start with a digit, so run them with ``-m``:

    python -m hugectr_backend_tpu_torch.examples.01_deploy_and_lookup --device cpu
    python -m hugectr_backend_tpu_torch.examples.02_fused_dlrm_serving

or load one with ``importlib.import_module``.
"""

NAMES = (
    "01_deploy_and_lookup",
    "02_fused_dlrm_serving",
    "03_online_updates",
    "04_sharded_multichip",
    "05_triton_repo_ensemble",
    "06_capacity_tiering_int4",
    "07_model_zoo",
    "08_kafka_groups_compression",
    "09_retrieval_topk",
)


def load(name: str):
    """The example module ``name`` (one of NAMES)."""
    import importlib

    return importlib.import_module(f"{__name__}.{name}")
