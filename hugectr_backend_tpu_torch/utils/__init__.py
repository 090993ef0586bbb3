from hugectr_backend_tpu_torch.utils.logging import get_logger

__all__ = ["get_logger"]
