from hugectr_backend_tpu_torch.tiers.hbm import DeviceTable, KeyIndex

__all__ = ["DeviceTable", "KeyIndex"]
