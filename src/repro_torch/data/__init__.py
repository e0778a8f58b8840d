"""The synthetic token stream (the port of ``repro.data``)."""
