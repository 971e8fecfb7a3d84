"""Decode engine on the mask cache: continuous batching over paged KV."""
from repro_torch.serve.engine import (
    EngineUnsupportedError,
    ServeConfig,
    ServeEngine,
    ServeReport,
)
from repro_torch.serve.mask_cache import PackedMaskCache
from repro_torch.serve.paged_kv import OutOfPagesError, PageAllocation, PagePool
from repro_torch.serve.scheduler import (
    ContinuousBatchingScheduler,
    Request,
    RequestState,
    ScheduleBucketCache,
)

__all__ = [
    "ContinuousBatchingScheduler",
    "EngineUnsupportedError",
    "OutOfPagesError",
    "PackedMaskCache",
    "PageAllocation",
    "PagePool",
    "Request",
    "RequestState",
    "ScheduleBucketCache",
    "ServeConfig",
    "ServeEngine",
    "ServeReport",
]
