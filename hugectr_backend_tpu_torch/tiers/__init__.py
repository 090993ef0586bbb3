__all__ = ["DeviceTable", "KeyIndex"]


def __getattr__(name):
    # Lazy: the host tiers (a DRAM pool node among them) import without torch.
    if name in __all__:
        from hugectr_backend_tpu_torch.tiers import hbm

        return getattr(hbm, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
