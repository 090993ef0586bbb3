from hugectr_backend_tpu_torch.utils.logging import get_logger
from hugectr_backend_tpu_torch.utils.timer import Timer

__all__ = ["Timer", "get_logger"]
