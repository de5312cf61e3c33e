from .shard import (CellMesh, ShardedStencil, make_cell_mesh,
                    make_sharded_stepper, shard_fluid_solver,
                    shard_solid_solver, sharded_element_cg,
                    sharded_insim_newton, sharded_stencil_asolve,
                    sharded_supg_newton, spawn_ranks)

__all__ = ["shard_fluid_solver", "shard_solid_solver",
           "sharded_element_cg", "sharded_insim_newton", "make_cell_mesh",
           "make_sharded_stepper", "sharded_supg_newton", "ShardedStencil",
           "sharded_stencil_asolve", "CellMesh", "spawn_ranks"]
