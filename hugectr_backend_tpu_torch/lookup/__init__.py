from hugectr_backend_tpu_torch.lookup.session import LookupSession

__all__ = ["LookupSession"]
