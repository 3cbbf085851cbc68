"""paddle_tpu_torch.distributed.launch — the multi-process launcher.

Counterpart of ``paddle_tpu/distributed/launch`` (Paddle's
python/paddle/distributed/launch, main.py:18): a Context parsed from
argv/env, a collective controller that builds the pod (one worker process
per rank with the PADDLE_* variables and ``torch.distributed``'s
``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``, which ``distributed.env`` reads), a TCPStore-backed master
KV for the rendezvous, and a watcher that restarts failed workers
(``ElasticManager`` for elastic ranges).

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 train.py

On an H100 host the normal deployment is one process per card
(``--nproc_per_node`` = the number of cards).
"""
from .context import Context  # noqa: F401
from .controller import CollectiveController, launch  # noqa: F401
