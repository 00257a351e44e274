"""Online inference: resident model store, micro-batched low-latency
scoring, serving metrics (port of ``photon_ml_tpu/serving/``: the
single-service path; publication and the fleet come later).
"""

from photon_ml_torch.serving.batcher import (BatcherDied, BatcherQueueFull,
                                             DeadlineExceeded, MicroBatcher,
                                             bucket_batch)
from photon_ml_torch.serving.metrics import (STAGES, SLOTracker,
                                             ServingMetrics)
from photon_ml_torch.serving.model_store import (HashShardedStore,
                                                 ResidentModelStore)
from photon_ml_torch.serving.service import (ScoringRequest, ScoringService,
                                             make_http_server,
                                             requests_from_dataset)

__all__ = [
    "BatcherDied",
    "BatcherQueueFull",
    "DeadlineExceeded",
    "MicroBatcher",
    "bucket_batch",
    "STAGES",
    "SLOTracker",
    "ServingMetrics",
    "HashShardedStore",
    "ResidentModelStore",
    "ScoringRequest",
    "ScoringService",
    "make_http_server",
    "requests_from_dataset",
]
