from repro_torch.serve.engine import (
    DEFAULT_BUCKETS, ContinuousEngine, ContinuousStats, Engine, OutputQueue,
    Request, ServeStats, SlotScheduler, sample_tokens,
)

__all__ = ["DEFAULT_BUCKETS", "ContinuousEngine", "ContinuousStats",
           "Engine", "OutputQueue", "Request", "ServeStats", "SlotScheduler",
           "sample_tokens"]
