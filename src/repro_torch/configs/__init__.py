"""Config dataclasses of the port (its own copy; see `base`) and the
arch registry: ``--arch <id>`` resolves here to the arch file's
``CONFIG``, ``FED`` overrides and ``CITATION``, as in the JAX
package."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (CommConfig, FedConfig, MLAConfig,
                                      ModelConfig, MoEConfig, ObsConfig,
                                      RobustConfig, SchedConfig)

ARCH_IDS = [
    "qwen3-moe-235b-a22b",
    "minicpm-2b",
    "qwen3-14b",
    "deepseek-v2-lite-16b",
    "hubert-xlarge",
    "gemma2-9b",
    "xlstm-1.3b",
    "qwen2-vl-2b",
    "chatglm3-6b",
    "recurrentgemma-2b",
]


def _module(arch_id: str):
    mod = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_model_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_fed_overrides(arch_id: str) -> dict:
    return getattr(_module(arch_id), "FED", {})


def get_citation(arch_id: str) -> str:
    return getattr(_module(arch_id), "CITATION", "")


__all__ = ["ARCH_IDS", "CommConfig", "FedConfig", "MLAConfig",
           "ModelConfig", "MoEConfig", "ObsConfig", "RobustConfig",
           "SchedConfig", "get_citation", "get_fed_overrides",
           "get_model_config"]
