"""``python -m enhance_cb_whisper_tpu_torch.cli {test,validate} --config cfg.yaml``,
on the card."""

from .main import run_cli

if __name__ == "__main__":
    run_cli()
