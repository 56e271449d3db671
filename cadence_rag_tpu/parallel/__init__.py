"""Multi-device scaling: device meshes, sharded index queries, collective
top-k merges across devices (SURVEY.md §2.4 — the reference has no
distributed compute; these are first-class components here)."""

from .mesh import make_mesh, parse_mesh_shape  # noqa: F401
from .sharded import sharded_dense_topk, sharded_multi_lane  # noqa: F401
