"""The package version: the JAX package's release string, which the port
tracks."""

__version__ = "0.1.0"
