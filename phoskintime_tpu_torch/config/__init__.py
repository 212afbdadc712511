"""Configuration: TOML loading and logging (importing this package loads
neither torch nor numpy), the device and dtype policy
(:mod:`~phoskintime_tpu_torch.config.numerics`) and labels."""

from phoskintime_tpu_torch.config.loader import (  # noqa: F401
    DEFAULT_BOUNDS,
    MODEL_NAMES,
    PhosKinConfig,
    find_config,
    load,
    load_config_toml,
)
from phoskintime_tpu_torch.config.logconf import setup_logger  # noqa: F401
