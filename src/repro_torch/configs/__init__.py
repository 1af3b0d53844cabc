from repro_torch.configs.base import (ARCH_IDS, ArchSpec, ShapeSpec,
                                      all_cells, get_arch)

__all__ = ["ARCH_IDS", "ArchSpec", "ShapeSpec", "all_cells", "get_arch"]
