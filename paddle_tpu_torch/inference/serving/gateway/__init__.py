"""paddle_tpu_torch.inference.serving.gateway: the engine behind a socket.

The PTSG/1 line protocol (``protocol``), the threaded gateway server with
graceful drain and per-connection read deadlines (``server``), and the
typed client with its circuit breaker (``client``). A request's TTL maps
onto the engine's per-request Deadline; the typed RequestTimeout travels
as a 408 frame, an overload shed (EngineOverloaded) as a 429 with
``retry-after-ms``, and load balancers poll the drain-aware HEALTH verb.
"""
from .client import (CircuitOpen, GatewayClient,  # noqa: F401
                     GatewayConnectionError)
from .protocol import GatewayDraining, ProtocolError  # noqa: F401
from .server import ServingGateway, gateway_info  # noqa: F401

__all__ = ["CircuitOpen", "GatewayClient", "GatewayConnectionError",
           "GatewayDraining", "ProtocolError", "ServingGateway",
           "gateway_info"]
