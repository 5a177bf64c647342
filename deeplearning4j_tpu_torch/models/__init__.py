"""Models of the port: ``TransformerLM`` and its ``DecodeEngine``, and
the DL4J model zoo (``models.zoo``)."""
