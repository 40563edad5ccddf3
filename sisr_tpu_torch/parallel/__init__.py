from .mesh import MeshContext, make_mesh, make_multihost_mesh  # noqa: F401
from .distributed import maybe_init_distributed  # noqa: F401
