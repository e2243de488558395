"""The reference's parallel layer on the port's one device: the
sharding rules as specs, the mesh context, and constraints that are the
identity."""

from repro_torch.parallel.sharding import (batch_shardings, cache_shardings,
                                           constrain, current_mesh,
                                           current_mode, mesh_logical_axes,
                                           param_shardings, param_spec,
                                           replicated, use_mesh)

__all__ = ["batch_shardings", "cache_shardings", "constrain", "current_mesh",
           "current_mode", "mesh_logical_axes", "param_shardings",
           "param_spec", "replicated", "use_mesh"]
