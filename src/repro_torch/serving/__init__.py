"""Serving stack: engine (route -> group -> generate -> feedback),
admission frontend (deadline-aware coalescing, backpressure), and the
open-loop traffic harness."""
from repro_torch.serving.engine import (FleetModel, Request, Response,
                                        ServingEngine)

__all__ = ["FleetModel", "Request", "Response", "ServingEngine"]
