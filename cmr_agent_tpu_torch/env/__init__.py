"""Registration environment, the episodes and the trajectory buffer."""
