"""Traffic drivers, one per kind of load; a mix file names its driver."""
