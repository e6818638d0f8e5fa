"""Numeric primitives: mel front end (with its CUDA kernel), similarity, resize."""
