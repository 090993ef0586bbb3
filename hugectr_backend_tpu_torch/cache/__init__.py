from hugectr_backend_tpu_torch.cache.embedding_cache import CacheConfig, EmbeddingCache

__all__ = ["EmbeddingCache", "CacheConfig"]
