"""Multiple slabs of one world: the spatial-domain halo step on the
in-process slab mesh (the reference's ``parallel/halo.py``)."""

from .halo import make_halo_step, unplace_fn  # noqa: F401
from .mesh import SlabMesh, make_mesh  # noqa: F401
