"""The port's command line: ``python -m enhance_cb_whisper_tpu_torch.cli
{test,validate} --config cfg.yaml`` (``cb-whisper.py test`` and
``kws.py test|validate`` of the JAX package)."""

from .config import apply_overrides, load_config
from .main import run_cli

__all__ = ["load_config", "apply_overrides", "run_cli"]
