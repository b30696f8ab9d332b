"""Serving: export a model to an artifact and answer predictions over HTTP."""

from .export import FORMAT_VERSION, LoadedArtifact, load_exported, save_exported
from .rollout import make_rollout
from .server import ModelServer, make_server, serve_forever

__all__ = [
    "FORMAT_VERSION",
    "LoadedArtifact",
    "ModelServer",
    "load_exported",
    "make_rollout",
    "make_server",
    "save_exported",
    "serve_forever",
]
