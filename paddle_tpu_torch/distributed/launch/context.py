"""Launch context: counterpart of ``paddle_tpu/distributed/launch/
context.py`` (Paddle's launch/context/__init__.py Context and the
launch/main.py arguments)."""
from __future__ import annotations

import argparse
import os
import socket
from dataclasses import dataclass, field
from typing import List, Optional


def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    p = s.getsockname()[1]
    s.close()
    return p


@dataclass
class Context:
    script: str = ""
    script_args: List[str] = field(default_factory=list)
    nnodes: int = 1
    node_rank: int = 0
    nproc_per_node: int = 1
    master: Optional[str] = None          # host:port of the rendezvous store
    job_id: str = "default"
    log_dir: str = "log"
    devices: Optional[str] = None
    max_restart: int = 3
    envs: dict = field(default_factory=dict)
    # elastic: nnodes given as 'min:max' turns on membership-based scaling
    np_max: int = 0

    @property
    def elastic(self) -> bool:
        return self.np_max > 0

    @classmethod
    def from_args(cls, argv=None) -> "Context":
        p = argparse.ArgumentParser(
            prog="python -m paddle_tpu_torch.distributed.launch",
            description="Launch distributed training (one process a rank)")
        p.add_argument("--nnodes", type=str, default=os.environ.get("PADDLE_NNODES", "1"),
                       help="number of nodes (or range 'min:max' — max ignored)")
        p.add_argument("--node_rank", type=int,
                       default=int(os.environ.get("PADDLE_NODE_RANK", "0")))
        p.add_argument("--nproc_per_node", type=int,
                       default=int(os.environ.get("PADDLE_NPROC_PER_NODE", "1")))
        p.add_argument("--master", type=str,
                       default=os.environ.get("PADDLE_MASTER"),
                       help="host:port of the rendezvous master (node 0)")
        p.add_argument("--job_id", type=str, default="default")
        p.add_argument("--log_dir", type=str, default="log")
        p.add_argument("--devices", "--gpus", type=str, default=None,
                       help="device selection (exported as PADDLE_DEVICES)")
        p.add_argument("--max_restart", type=int, default=3)
        p.add_argument("script", type=str)
        p.add_argument("script_args", nargs=argparse.REMAINDER)
        a = p.parse_args(argv)
        parts = str(a.nnodes).split(":")
        nnodes = int(parts[0])
        np_max = int(parts[1]) if len(parts) > 1 else 0
        if np_max and np_max < nnodes:
            raise SystemExit(f"--nnodes {a.nnodes}: max must be >= min")
        master = a.master
        if master is None and (nnodes > 1 or np_max > 0):
            # elastic with min=1 still needs a discoverable store endpoint,
            # or joining nodes could never find the rendezvous
            raise SystemExit("--master host:port is required for nnodes > 1 "
                             "and for elastic ranges ('min:max')")
        if master is None:
            master = f"127.0.0.1:{_free_port()}"
        return cls(script=a.script, script_args=a.script_args, nnodes=nnodes,
                   node_rank=a.node_rank, nproc_per_node=a.nproc_per_node,
                   master=master, job_id=a.job_id, log_dir=a.log_dir,
                   devices=a.devices, max_restart=a.max_restart,
                   np_max=np_max)

    @property
    def world_size(self) -> int:
        return self.nnodes * self.nproc_per_node

    def is_master_node(self) -> bool:
        return self.node_rank == 0
