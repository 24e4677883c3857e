"""Serving on the port: the simulator picks the admission policy
(``bridge``), the continuous batcher serves under it (``batching``)."""
from .batching import ContinuousBatcher, Request
from .bridge import ServeRequest, evaluate_policies, pick_policy, requests_to_pipelines

__all__ = [
    "ContinuousBatcher",
    "Request",
    "ServeRequest",
    "evaluate_policies",
    "pick_policy",
    "requests_to_pipelines",
]
