"""Core of the paper's method, in torch.

deform.py     Eq. 1-3 unified deformable-convolution model (DCN-I/II)
tiles.py      Tile Dependency Table (TDT), §IV-C Fig. 9
scheduler.py  Algorithm 1 runtime tile scheduler + FIFO buffer model
simulator.py  DRAM traffic + energy simulator (Table II model)
fusion.py     BLI (+) conv stage-fusion planner, §IV-D

The names below resolve on first use: ``scheduler`` imports the schedule
kernels, which import ``tiles`` from this package, so importing them here
would close that cycle whenever the kernels module is imported first.
"""

import importlib

_EXPORTS = {
    "deform": ("DeformableConvParams", "bilinear_sample", "bli_coefficients",
               "conv2d", "deformable_conv2d", "fused_deformable_conv2d",
               "init_deformable_conv", "offsets_to_coords"),
    "fusion": ("FusionMode", "FusionPlan", "GroupPlan", "LayerShape",
               "plan_fused_groups", "plan_fusion", "plan_network"),
    "scheduler": ("FifoBuffer", "TileSchedule", "assemble_device_schedule",
                  "schedule_tiles", "schedule_tiles_device",
                  "sequential_schedule"),
    "simulator": ("DramEnergyModel", "GroupTrafficReport",
                  "NetworkTrafficReport", "TrafficReport", "dram_energy",
                  "simulate_group", "simulate_network",
                  "simulate_strategies"),
    "tiles": ("TileGrid", "access_histogram", "compose_tdt",
              "compose_tdt_chain", "make_square_grid",
              "per_pixel_input_tiles", "tdt_from_coords",
              "tdt_standard_conv", "tile_access_histogram"),
}
_MODULE_OF = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = sorted(_MODULE_OF)


def __getattr__(name: str):
    mod = _MODULE_OF.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
