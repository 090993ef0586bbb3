from hugectr_backend_tpu_torch.models.dlrm import DLRM, load_flax_dlrm_params

__all__ = ["DLRM", "load_flax_dlrm_params"]
