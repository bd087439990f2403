"""Multiple slabs of one world on the in-process slab mesh: the
spatial-domain halo step (the reference's ``parallel/halo.py``) and the
position-homed step (``parallel/homed.py``)."""

from .halo import make_halo_step, unplace_fn  # noqa: F401
from .homed import make_homed_step  # noqa: F401
from .mesh import SlabMesh, make_mesh  # noqa: F401
