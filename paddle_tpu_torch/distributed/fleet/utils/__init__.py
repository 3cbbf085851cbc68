"""``fleet.utils``: the file-system clients, the ``recompute`` re-export
and ``DistributedInfer``.

Counterpart of ``paddle_tpu/distributed/fleet/utils/__init__.py`` (after
Paddle's ``fleet/utils/fs.py`` and ``ps_util.py``). ``HDFSClient`` needs a
hadoop installation and raises, as the reference's does.
"""
from __future__ import annotations

import os
import shutil

from ..recompute import recompute  # noqa: F401

__all__ = ["LocalFS", "recompute", "DistributedInfer", "HDFSClient"]


class LocalFS:
    """Local file-system client (Paddle's ``fleet/utils/fs.py`` LocalFS)."""

    def ls_dir(self, path):
        dirs, files = [], []
        for n in sorted(os.listdir(path)):
            (dirs if os.path.isdir(os.path.join(path, n)) else files).append(n)
        return dirs, files

    def mkdirs(self, path):
        os.makedirs(path, exist_ok=True)

    def is_file(self, path):
        return os.path.isfile(path)

    def is_dir(self, path):
        return os.path.isdir(path)

    def is_exist(self, path):
        return os.path.exists(path)

    def touch(self, path, exist_ok=True):
        if os.path.exists(path) and not exist_ok:
            raise FileExistsError(path)
        open(path, "a").close()

    def mv(self, src, dst, overwrite=False):
        if os.path.exists(dst) and not overwrite:
            raise FileExistsError(dst)
        shutil.move(src, dst)

    def delete(self, path):
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.unlink(path)

    def need_upload_download(self):
        return False

    def list_dirs(self, path):
        return self.ls_dir(path)[0]


class HDFSClient:
    """HDFS client surface: it needs a hadoop binary, so construction
    raises with guidance."""

    def __init__(self, hadoop_home=None, configs=None, time_out=300000,
                 sleep_inter=1000):
        raise RuntimeError(
            "HDFSClient requires a hadoop installation (unavailable in this "
            "environment); use LocalFS, or mount the data locally")


class DistributedInfer:
    """Distributed inference helper surface (Paddle's ``ps_util.py``): a
    parameter-server helper there; here it hands back the program it was
    given (there is no server role)."""

    def __init__(self, main_program=None, startup_program=None):
        self._main = main_program

    def init_distributed_infer_env(self, exe, loss, role_maker=None,
                                   dirname=None):
        return None

    def get_dist_infer_program(self):
        return self._main
