"""Models of the port: ``TransformerLM`` and its ``DecodeEngine``."""
