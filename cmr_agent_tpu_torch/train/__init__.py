"""Weight bridge from the JAX package, optimizer, training steps and the
serving export."""

from .export import (  # noqa: F401
    export_geo_forward, export_episode, export_composed_pipeline,
    load_exported,
)
