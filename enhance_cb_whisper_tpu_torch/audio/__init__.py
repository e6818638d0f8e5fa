"""Audio decode and Whisper feature preparation."""
