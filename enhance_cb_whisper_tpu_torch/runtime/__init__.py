"""Runtime helpers (throughput meter)."""
