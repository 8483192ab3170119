from repro_torch.configs.registry import (ARCH_IDS, SHAPES,  # noqa: F401
                                          get_config, shape_applicable,
                                          smoke_config)
