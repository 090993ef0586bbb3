from hugectr_backend_tpu_torch.cache.embedding_cache import EmbeddingCache

__all__ = ["EmbeddingCache"]
