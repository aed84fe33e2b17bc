"""Shared utilities of the launch path (the port's own copies of the JAX
package's utils/ modules the client and the executor reach)."""

from .localization import (
    ResourceSpec,
    localize_resources,
    parse_resources,
    stage_resources,
)

__all__ = [
    "ResourceSpec", "parse_resources", "stage_resources", "localize_resources",
]
