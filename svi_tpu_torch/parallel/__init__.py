"""Running SVI over several ranks (port of svi_tpu/parallel): process
meshes (`mesh`), the cross-rank operations (`collectives`), the
sequence-parallel forward (`sequence_parallel`), tensor parallelism
(`tensor_parallel`) and both together (`tp_sp`)."""

from .mesh import (Mesh, init_distributed, is_main_rank, make_mesh, make_sp_mesh,
                   make_training_mesh)

__all__ = ["Mesh", "init_distributed", "is_main_rank", "make_mesh", "make_sp_mesh",
           "make_training_mesh"]
