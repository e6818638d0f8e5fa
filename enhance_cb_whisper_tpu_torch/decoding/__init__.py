"""Logits processors, top-k, beam/greedy search, prompts and generation."""
