"""Python client + CLI for the REST API (port of cruise_control_tpu/
client/; SURVEY.md §2.10)."""
from cruise_control_tpu_torch.client.client import (
    CruiseControlClient, CruiseControlClientError)

__all__ = ["CruiseControlClient", "CruiseControlClientError"]
