from hugectr_backend_tpu_torch.models.bst import BST, load_flax_bst_params
from hugectr_backend_tpu_torch.models.dcn import DCNv2, load_flax_dcn_params
from hugectr_backend_tpu_torch.models.deepfm import DeepFM, load_flax_deepfm_params
from hugectr_backend_tpu_torch.models.din import DIN, load_flax_din_params
from hugectr_backend_tpu_torch.models.dlrm import DLRM, load_flax_dlrm_params
from hugectr_backend_tpu_torch.models.mmoe import MMoE, load_flax_mmoe_params
from hugectr_backend_tpu_torch.models.ncf import NCF, load_flax_ncf_params
from hugectr_backend_tpu_torch.models.quant_dense import (
    QuantDense,
    quantize_dense_params,
    quantize_model_params,
    quantize_weight,
)
from hugectr_backend_tpu_torch.models.two_tower import TwoTowerUser, load_flax_two_tower_params
from hugectr_backend_tpu_torch.models.wdl import WideAndDeep, load_flax_wdl_params
from hugectr_backend_tpu_torch.models.xdeepfm import XDeepFM, load_flax_xdeepfm_params

__all__ = [
    "DLRM",
    "WideAndDeep",
    "DCNv2",
    "DIN",
    "DeepFM",
    "XDeepFM",
    "NCF",
    "TwoTowerUser",
    "BST",
    "MMoE",
    "load_flax_dlrm_params",
    "load_flax_wdl_params",
    "load_flax_dcn_params",
    "load_flax_din_params",
    "load_flax_deepfm_params",
    "load_flax_xdeepfm_params",
    "load_flax_ncf_params",
    "load_flax_two_tower_params",
    "load_flax_bst_params",
    "load_flax_mmoe_params",
    "QuantDense",
    "quantize_dense_params",
    "quantize_model_params",
    "quantize_weight",
]
