"""Serving tier — batched, multi-model scoring on the card — the port of
``h2o3_tpu/serving/``.

The production scoring path: ``/3/Score/{model}`` takes row payloads (no
DKV frame round-trip), the micro-batcher fuses concurrent requests into one
device dispatch, the ScorerCache keeps one CUDA graph per (model,
signature, batch-bucket), and multi-model residency is byte-accounted with
LRU eviction under a budget.
"""

from h2o3_tpu_torch.serving.batcher import Evicted, ModelBatcher
from h2o3_tpu_torch.serving.replicas import ReplicaPool, ScoringReplica
from h2o3_tpu_torch.serving.schema import (NotServable, ServingSchema,
                                           serving_schema)
from h2o3_tpu_torch.serving.scorer import (CompiledScorer, ScorerCache,
                                           bucket_for)
from h2o3_tpu_torch.serving.service import (SCORING, ScoringService,
                                            ServiceUnavailable)
from h2o3_tpu_torch.serving.slo import Shed, SLOController, clamp_priority

__all__ = ["SCORING", "ScoringService", "ServiceUnavailable", "ScorerCache",
           "CompiledScorer", "ModelBatcher", "Evicted", "ServingSchema",
           "NotServable", "serving_schema", "bucket_for", "SLOController",
           "Shed", "clamp_priority", "ReplicaPool", "ScoringReplica"]
