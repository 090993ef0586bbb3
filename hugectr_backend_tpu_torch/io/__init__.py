from hugectr_backend_tpu_torch.io.sparse_model import (
    SparseModelTable,
    read_sparse_model,
    write_sparse_model,
)
from hugectr_backend_tpu_torch.io.synthetic import (
    make_criteo_like_batch,
    make_synthetic_table,
)

__all__ = [
    "SparseModelTable",
    "read_sparse_model",
    "write_sparse_model",
    "make_criteo_like_batch",
    "make_synthetic_table",
    "DenseModel",
    "save_dense_model",
    "convert_torch_sequential",
    "load_repository",
    "load_model_repository",
    "parse_pbtxt",
]

_DENSE = ("DenseModel", "save_dense_model", "convert_torch_sequential")
_REPO = ("load_repository", "load_model_repository", "parse_pbtxt")


def __getattr__(name):
    # Lazy: the sparse-model and synthetic utilities import without torch.
    if name in _DENSE:
        from hugectr_backend_tpu_torch.io import dense_model

        return getattr(dense_model, name)
    if name in _REPO:
        from hugectr_backend_tpu_torch.io import model_repo

        return getattr(model_repo, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
