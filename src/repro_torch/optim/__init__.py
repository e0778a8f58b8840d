"""AdamW and its schedule (the port of ``repro.optim``)."""
