"""Config dataclasses of the port (its own copy; see `base`)."""
from repro_torch.configs.base import (CommConfig, FedConfig, ObsConfig,
                                      RobustConfig, SchedConfig)

__all__ = ["CommConfig", "FedConfig", "ObsConfig", "RobustConfig",
           "SchedConfig"]
