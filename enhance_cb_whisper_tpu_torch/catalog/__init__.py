"""Keyword catalog and its batched scorer."""
