"""GLM optimization problems."""
