"""Registry and YAML config of the port."""
