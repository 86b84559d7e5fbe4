"""Plain references of the model families, one module a family."""
