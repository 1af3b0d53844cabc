"""The multi-device layer (counterparts of ``repro.distributed``)."""
