"""The continuous-batching serving stack of the port: the paged KV pool
(``kv_cache``), the scheduler (``scheduler``), per-request results, fault
injection and crash recovery (``resilience``) and the engine
(``engine``)."""
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.kv_cache import AuditError, KVPagePool
from repro_torch.serving.resilience import (CapacityExceeded,
                                            DeadlineExceeded, EngineCrash,
                                            Fault, FaultInjector,
                                            PoisonedOutput, RequestError,
                                            Response, Shed,
                                            serve_with_recovery)
from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                           DeadlineScheduler)

__all__ = ["Request", "ServingEngine", "KVPagePool", "AuditError",
           "ContinuousBatchingScheduler", "DeadlineScheduler",
           "RequestError", "DeadlineExceeded", "Shed", "PoisonedOutput",
           "CapacityExceeded", "EngineCrash", "Response", "Fault",
           "FaultInjector", "serve_with_recovery"]
