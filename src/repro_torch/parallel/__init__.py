"""The reference's parallel layer: the sharding rules as specs, the
mesh context, the placement of parameters, batches and decode caches on
a mesh of ranks (``sharding``), the collectives and autograd rules of
the sharded model (``comm``), and the process group a mesh lives on
(``runtime``)."""

from repro_torch.parallel.sharding import (batch_shardings, cache_shardings,
                                           constrain, current_mesh,
                                           current_mode, mesh_logical_axes,
                                           param_shardings, param_spec,
                                           place_batch, place_cache,
                                           place_params, replicated,
                                           use_mesh)

__all__ = ["batch_shardings", "cache_shardings", "constrain", "current_mesh",
           "current_mode", "mesh_logical_axes", "param_shardings",
           "param_spec", "place_batch", "place_cache", "place_params",
           "replicated", "use_mesh"]
