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
]
