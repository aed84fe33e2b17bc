"""Cluster capacity layer: the provisioners (the port's own copy of the
JAX package's cluster/ package, without its TPU slice lifecycle)."""

from .provisioner import (
    ContainerHandle,
    LocalProvisioner,
    Provisioner,
    StaticHostProvisioner,
    create_provisioner,
)

__all__ = [
    "ContainerHandle",
    "LocalProvisioner",
    "Provisioner",
    "StaticHostProvisioner",
    "create_provisioner",
]
