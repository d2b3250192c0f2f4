"""The ten assigned LM architectures, the counterpart of
``repro.configs``."""
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec
from repro_torch.configs.registry import (ARCH_IDS, cells, get_config,
                                         input_specs)

__all__ = ["SHAPES", "ArchConfig", "ShapeSpec", "ARCH_IDS", "get_config",
           "input_specs", "cells"]
