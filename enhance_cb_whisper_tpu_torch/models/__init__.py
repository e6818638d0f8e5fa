"""Whisper, the ResNet KWS classifier and the CB-Whisper pipeline."""
