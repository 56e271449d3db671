"""Mesh construction helpers.

Mesh axes: "data" shards the corpus (document rows of the index arrays) —
the axis that grows with corpus size; "model" shards the in-process
embedder's weights (Megatron tp). The mesh follows the algorithm alone:
every device reaches every other (NVLink within a host), so no axis order
is tied to a physical topology.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def parse_mesh_shape(spec: str) -> List[Tuple[str, int]]:
    """"data:4,model:2" -> [("data", 4), ("model", 2)]."""
    out: List[Tuple[str, int]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, size = part.partition(":")
        out.append((name.strip(), int(size)))
    return out


def make_mesh(
    spec: Optional[str] = None, devices: Optional[list] = None
) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if spec:
        axes = parse_mesh_shape(spec)
    else:
        axes = [("data", len(devices))]
    shape = tuple(size for _name, size in axes)
    names = tuple(name for name, _size in axes)
    total = int(np.prod(shape))
    if total != len(devices):
        raise ValueError(
            f"mesh {dict(axes)} needs {total} devices, have {len(devices)}"
        )
    return Mesh(np.asarray(devices).reshape(shape), names)
