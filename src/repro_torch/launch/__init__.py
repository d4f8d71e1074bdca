"""Launchers: the port of ``repro.launch`` (``serve`` so far)."""
