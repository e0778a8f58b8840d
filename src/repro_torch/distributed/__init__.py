"""Fault tolerance of the training loop (the port of the stdlib-only part
of ``repro.distributed``; sharding and collectives are ROADMAP A12)."""
