"""Runtime helpers: throughput meter, KWS engine, reference precision."""
