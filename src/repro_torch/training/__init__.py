"""LM training: AdamW, the train loop, checkpoint/restart, gradient
compression and straggler detection (counterparts of ``repro.training``)."""
