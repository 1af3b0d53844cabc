"""RAGO's planner: schema, stage registry, cost model, optimizer and
serving plan (copies of ``repro.core``; see each module)."""
