"""The program under test for a paper-2 LEF configuration: the port's
``EfficientKWSModel`` built from the configuration file and the run's
seed, in the compute type a cell serves it in.

The model's ResNet takes its sizes from the configuration file (resnet-50's
own at full size) through a configuration subclass, as the repository's
tests size it down.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import weights

SALT_LEF = 3


def model_config(cfg: dict):
    from enhance_cb_whisper_tpu_torch.efficient_kws.model import EfficientKWSConfig
    from enhance_cb_whisper_tpu_torch.models.resnet import ResNetConfig

    r = cfg["resnet"]

    @dataclasses.dataclass(frozen=True)
    class Config(EfficientKWSConfig):
        def resnet_config(self) -> ResNetConfig:
            return ResNetConfig(num_channels=self.n_layers, embedding_size=r["embedding_size"],
                                hidden_sizes=tuple(r["hidden_sizes"]), depths=tuple(r["depths"]),
                                layer_type=r["layer_type"], num_labels=2)

    return Config(n_layers=cfg["n_layers"], embedding_dim=cfg["embedding_dim"],
                  learn_features=cfg["learn_features"], proj_mlp=cfg["proj_mlp"],
                  proj_mlp_units=cfg["proj_mlp_units"], frames_conv=cfg["frames_conv"])


def build(cfg: dict, seed: int, device, dtype: torch.dtype):
    """The port's LEF model on ``device`` in eval mode, computing in ``dtype``."""
    from enhance_cb_whisper_tpu_torch.efficient_kws.model import EfficientKWSModel

    with torch.device(device):
        model = EfficientKWSModel(model_config(cfg), dtype=dtype, input_dim=cfg.get("input_dim"))
    model.load_converted(weights.materialize(weights.lef_spec(cfg), seed, SALT_LEF, device))
    return model.eval()
