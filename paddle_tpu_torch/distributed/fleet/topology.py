"""The hybrid-parallel topology: ``CommunicateTopology`` and
``HybridCommunicateGroup``.

Counterpart of ``paddle_tpu/distributed/fleet/topology.py`` (after
Paddle's ``fleet/base/topology.py``). The (data, pipe, sharding, sep,
model) process grid becomes the port's ``DeviceMesh`` (axes dp, pp,
sharding, sep, mp, row-major over the ranks as Paddle lays them out), and
each getter returns a ``collective.Group`` over that mesh axis. The JAX
package is one program over every device, so its rank getters return 0;
here each rank is a process, and they return this rank's coordinate on
the axis (Paddle's meaning).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ...parallel import mesh as mesh_mod
from ..collective import new_group

__all__ = ["CommunicateTopology", "HybridCommunicateGroup", "ParallelMode",
           "get_hcg", "set_hcg"]


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "sharding",
                                           "model"), dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(int(d) for d in dims)
        self._world_size = int(np.prod(self._dims))

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world_size

    def get_rank(self, **kwargs):
        coords = [kwargs[n] for n in self._parallel_names]
        return int(np.ravel_multi_index(coords, self._dims))

    def get_coord(self, rank):
        return tuple(int(c) for c in np.unravel_index(rank, self._dims))

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        return [r for r in range(self._world_size)
                if self.get_coord(r)[axis] == index]

    def get_comm_list(self, axis_name):
        """Every rank group along ``axis_name``, one per combination of the
        other coordinates (topology.py get_comm_list)."""
        axis = self._parallel_names.index(axis_name)
        others = [i for i in range(len(self._dims)) if i != axis]
        out = []
        for combo in np.ndindex(*[self._dims[i] for i in others]):
            ranks = []
            for k in range(self._dims[axis]):
                coord = [0] * len(self._dims)
                for i, o in enumerate(others):
                    coord[o] = combo[i]
                coord[axis] = k
                ranks.append(int(np.ravel_multi_index(coord, self._dims)))
            out.append(ranks)
        return out


# fleet axis name -> mesh axis name
_AXIS_MAP = {"data": "dp", "pipe": "pp", "sharding": "sharding",
             "model": "mp", "sep": "sep"}


class HybridCommunicateGroup:
    """Installs the topology's mesh (``parallel.init_mesh``: collective,
    every rank builds it) and serves its axes as groups."""

    def __init__(self, topology: CommunicateTopology):
        self._topo = topology
        names = topology.get_hybrid_group_names()
        dims = [topology.get_dim(n) for n in names]
        self.nranks = topology.world_size()

        def deg(n):
            return topology.get_dim(n) if n in names else 1
        self._dp_degree = deg("data")
        self._pp_degree = deg("pipe")
        self._sharding_degree = deg("sharding")
        self._mp_degree = deg("model")
        self._sep_degree = deg("sep")

        self._mesh = mesh_mod.init_mesh(
            {_AXIS_MAP.get(n, n): d for n, d in zip(names, dims)})
        self._dp_group = new_group(axis="dp")
        self._pp_group = new_group(axis="pp")
        self._sharding_group = new_group(axis="sharding")
        self._mp_group = new_group(axis="mp")
        self._sep_group = new_group(axis="sep") if self._sep_degree > 1 \
            else None

    def _coord(self, axis: str) -> int:
        return mesh_mod.axis_index(axis, self._mesh)

    # --- degrees / world info ---
    def get_parallel_mode(self):
        if self._mp_degree == 1 and self._pp_degree == 1 \
                and self._sharding_degree == 1:
            return ParallelMode.DATA_PARALLEL
        if self._pp_degree > 1:
            return ParallelMode.PIPELINE_PARALLEL
        if self._sharding_degree > 1 and self._mp_degree == 1:
            return ParallelMode.SHARDING_PARALLEL
        return ParallelMode.TENSOR_PARALLEL

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    # --- this rank's coordinates (a process per rank) ---
    def get_data_parallel_rank(self):
        return self._coord("dp")

    def get_model_parallel_rank(self):
        return self._coord("mp")

    def get_stage_id(self):
        return self._coord("pp")

    def get_sharding_parallel_rank(self):
        return self._coord("sharding")

    # --- groups ---
    def get_data_parallel_group(self):
        return self._dp_group

    def get_model_parallel_group(self):
        return self._mp_group

    def get_pipe_parallel_group(self):
        return self._pp_group

    def get_sharding_parallel_group(self):
        return self._sharding_group

    def get_sep_parallel_group(self):
        return self._sep_group

    def get_check_parallel_group(self, sharding=False):
        return self._mp_group

    def get_data_parallel_group_src_rank(self):
        return self._dp_group.ranks[0]

    def get_model_parallel_group_src_rank(self):
        return self._mp_group.ranks[0]

    def topology(self):
        return self._topo

    @property
    def mesh(self):
        return self._mesh


class ParallelMode:
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


_hcg: Optional[HybridCommunicateGroup] = None


def set_hcg(hcg):
    global _hcg
    _hcg = hcg


def get_hcg() -> Optional[HybridCommunicateGroup]:
    return _hcg
