from hugectr_backend_tpu_torch.ps.parameter_server import HierParameterServer

__all__ = ["HierParameterServer"]
