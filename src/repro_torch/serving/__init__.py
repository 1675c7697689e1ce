"""Elastic serving on the card: continuous batching over nested FlexRank
submodels with a block-paged KV cache, budget-aware scheduling and
per-request sampling."""
from repro_torch.serving.batcher import ContinuousBatcher
from repro_torch.serving.engine import CacheOOM, ElasticEngine, Request, Result
from repro_torch.serving.kv_cache import BlockAllocator, PagedKVCache
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.sampling import SamplerState, SamplingParams
from repro_torch.serving.scheduler import BudgetRouter, Scheduler, Sequence

__all__ = [
    "BlockAllocator", "BudgetRouter", "CacheOOM", "ContinuousBatcher",
    "ElasticEngine", "PagedKVCache", "Request", "Result", "SamplerState",
    "SamplingParams", "Scheduler", "Sequence", "ServingMetrics",
]
