"""The port's configuration schema (``config.schema``)."""
