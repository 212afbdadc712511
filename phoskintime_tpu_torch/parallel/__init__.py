"""Long-run support: checkpoint and resume."""
