"""Atomic, async checkpoints (the port of ``repro.checkpoint``)."""
