"""Registration environment and the eval episode."""
