"""Host-side utilities: the deadlines and their typed errors
(``deadline``), the flags (``flags``) and the host runtime's loader
(``native``)."""
from .deadline import (  # noqa: F401
    DataLoaderTimeout, Deadline, DeadlineExceeded, RpcTimeout,
    StoreConnectionError, StoreTimeout,
)
