"""The online update path: trainer -> broker or file queue -> the DRAM and SSD
tiers (port of the JAX package's update/)."""

from hugectr_backend_tpu_torch.update.source import (
    FileQueueSource,
    MessageProducer,
    MessageSource,
    UpdateConsumer,
    make_update_source,
)

__all__ = [
    "FileQueueSource",
    "MessageProducer",
    "MessageSource",
    "UpdateConsumer",
    "make_update_source",
]
