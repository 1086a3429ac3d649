from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    ShapeCfg,
    SHAPES,
    get_arch,
    list_archs,
    reduced,
    input_specs,
    cell_is_supported,
)
