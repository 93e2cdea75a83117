"""The geo model and the refinement agent (eval forward)."""
