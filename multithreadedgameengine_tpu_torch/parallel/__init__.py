"""Multiple slabs of one world: the spatial-domain halo step (the
reference's ``parallel/halo.py``) and the position-homed step
(``parallel/homed.py``) on a slab mesh, either every slab in one process
(``make_mesh``) or one slab per process of a ``torch.distributed`` group
(``make_process_mesh``, started by ``run_ranks``); and the entity-sharded
step (``parallel/sharded.py``) on a process mesh."""

from .dist import ProcessMesh, make_process_mesh  # noqa: F401
from .halo import make_halo_step, unplace_fn  # noqa: F401
from .homed import make_homed_step  # noqa: F401
from .launch import RankError, run_ranks  # noqa: F401
from .mesh import SlabMesh, make_mesh  # noqa: F401
from .sharded import make_sharded_step, shard_world  # noqa: F401
