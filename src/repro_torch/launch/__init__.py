"""Command-line entry points of the port."""

from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     mesh_chips)
