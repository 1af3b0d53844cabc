"""Launchers of the port (counterparts of ``repro.launch``)."""
