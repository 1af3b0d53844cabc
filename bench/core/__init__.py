"""The harness: spec discovery, traffic, the cell driver, tracing, judging."""
