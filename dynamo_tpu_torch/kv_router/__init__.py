"""KV-cache-aware routing (the port's copy of the JAX package's
kv_router/; reference lib/llm/src/kv_router/, SURVEY.md §2.3): engines
publish block stored/removed events (protocols.py); the global indexer
maps chained block hashes to the workers holding them (indexer.py);
per-worker active-sequence tracking predicts load (sequence.py); the
scheduler scores workers by ``overlap_weight * prefill_blocks +
potential_active_blocks`` and softmax-samples one (scheduler.py);
KvPushRouter routes and streams (router.py); MetricsAggregator collects
worker load (metrics_aggregator.py).

The fleet view and the prefetch controller (fleet.py, prefetch.py) come
with ROADMAP Queue 1 item 6.
"""
from dynamo_tpu_torch.kv_router.indexer import (
    ApproxKvIndexer,
    KvIndexer,
    OverlapScores,
)
from dynamo_tpu_torch.kv_router.metrics_aggregator import (
    MetricsAggregator,
    ProcessedEndpoints,
)
from dynamo_tpu_torch.kv_router.protocols import (
    ForwardPassMetrics,
    KvCacheEvent,
    KvEventKind,
    KvStats,
    StoredBlock,
    WorkerStats,
)
from dynamo_tpu_torch.kv_router.router import KvPushRouter, KvRouter
from dynamo_tpu_torch.kv_router.scheduler import (
    DefaultWorkerSelector,
    KvRouterConfig,
    KvScheduler,
    KVHitRateEvent,
    SchedulingRequest,
    softmax_sample,
)
from dynamo_tpu_torch.kv_router.sequence import (
    ActiveSequences,
    ActiveSequencesMultiWorker,
)

__all__ = [
    "ApproxKvIndexer", "KvIndexer", "OverlapScores",
    "MetricsAggregator", "ProcessedEndpoints",
    "ForwardPassMetrics", "KvCacheEvent", "KvEventKind", "KvStats",
    "StoredBlock", "WorkerStats",
    "KvPushRouter", "KvRouter",
    "DefaultWorkerSelector", "KvRouterConfig", "KvScheduler",
    "KVHitRateEvent", "SchedulingRequest", "softmax_sample",
    "ActiveSequences", "ActiveSequencesMultiWorker",
]
