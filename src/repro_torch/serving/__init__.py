"""The continuous-batching serving stack of the port: the paged KV pool
(``kv_cache``), the scheduler (``scheduler``), per-request results
(``resilience``) and the engine (``engine``)."""
