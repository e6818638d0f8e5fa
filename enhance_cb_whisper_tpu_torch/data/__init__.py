"""Evaluation datasets and the eval half of the KWS data module."""
