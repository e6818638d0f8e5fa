"""The comparisons that decide ``correct``, one per kind of configuration."""
