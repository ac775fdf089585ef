"""Serving stack: the engine (route -> group -> generate -> feedback).
The JAX package's admission frontend and traffic harness are not ported
yet."""
from repro_torch.serving.engine import (FleetModel, Request, Response,
                                        ServingEngine)

__all__ = ["FleetModel", "Request", "Response", "ServingEngine"]
