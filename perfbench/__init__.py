"""The benchmark of the PyTorch/CUDA port (``enhance_cb_whisper_tpu_torch``).
Run a cell with ``python3 perfbench/run.py``; see README.md."""
