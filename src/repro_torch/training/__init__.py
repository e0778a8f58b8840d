"""The train step (the port of ``repro.training``)."""
