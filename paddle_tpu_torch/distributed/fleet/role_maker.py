"""Role makers: this process's role in the cluster.

Counterpart of ``paddle_tpu/distributed/fleet/role_maker.py`` (after
Paddle's ``fleet/base/role_maker.py``). In collective training every
process is a worker (no parameter servers), so the server side answers
empty or False; the surface is kept so ``fleet.init(role_maker)`` carries
over. ``PaddleCloudRoleMaker`` reads the launcher's ``PADDLE_TRAINER_ID``
/ ``PADDLE_TRAINERS_NUM`` / ``PADDLE_TRAINER_ENDPOINTS`` (or torchrun's
``RANK`` / ``WORLD_SIZE``), else the process group's rank and size.
"""
from __future__ import annotations

import os
from typing import List

__all__ = ["Role", "RoleMakerBase", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker"]


def _env(*names, default: str) -> str:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return v
    return default


class Role:
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4
    COORDINATOR = 5


class RoleMakerBase:
    def __init__(self):
        self._worker_endpoints: List[str] = []
        self._server_endpoints: List[str] = []
        self._role_is_generated = False
        self._role = Role.WORKER
        self._current_id = 0

    def _generate_role(self):
        self._role_is_generated = True

    def _is_worker(self):
        return self._role == Role.WORKER

    def _is_server(self):
        return self._role == Role.SERVER

    def _is_first_worker(self):
        return self._is_worker() and self._worker_index() == 0

    def _worker_index(self):
        return self._current_id

    def _server_index(self):
        return 0

    def _worker_num(self):
        return max(len(self._worker_endpoints), 1)

    def _server_num(self):
        return len(self._server_endpoints)

    def _get_trainer_endpoints(self):
        return list(self._worker_endpoints)

    def _get_pserver_endpoints(self):
        return list(self._server_endpoints)

    def _barrier(self, comm_world=None):
        from ..env import is_initialized
        if is_initialized():
            from ..collective import barrier
            barrier()

    def _role_id(self):
        return self._worker_index() if self._is_worker() \
            else self._server_index()


class PaddleCloudRoleMaker(RoleMakerBase):
    def __init__(self, is_collective=True, **kwargs):
        super().__init__()
        self._is_collective = is_collective
        self._kwargs = kwargs
        self._generate_role()

    def _generate_role(self):
        from ..env import get_rank, get_world_size
        self._current_id = int(_env("PADDLE_TRAINER_ID", "RANK",
                                    default=str(get_rank())))
        n = int(_env("PADDLE_TRAINERS_NUM", "WORLD_SIZE",
                     default=str(get_world_size())))
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._worker_endpoints = eps.split(",") if eps else \
            [f"127.0.0.1:{6170 + i}" for i in range(n)]
        self._role = Role.WORKER
        self._role_is_generated = True

    def _worker_num(self):
        return int(_env("PADDLE_TRAINERS_NUM", "WORLD_SIZE",
                        default=str(max(len(self._worker_endpoints), 1))))


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    def __init__(self, is_collective=True, current_id=0, role=Role.WORKER,
                 worker_num=1, worker_endpoints=None, **kwargs):
        self._init_id = current_id
        self._init_role = role
        self._init_num = worker_num
        self._init_eps = worker_endpoints or []
        super().__init__(is_collective=is_collective, **kwargs)

    def _generate_role(self):
        self._current_id = self._init_id
        self._role = self._init_role
        self._worker_endpoints = list(self._init_eps) or \
            [f"127.0.0.1:{6170 + i}" for i in range(self._init_num)]
        self._role_is_generated = True

    def _worker_num(self):
        return self._init_num
