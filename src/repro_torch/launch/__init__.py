"""Launchers (the port of ``repro.launch``: training so far)."""
