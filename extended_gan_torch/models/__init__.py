"""Model families of the port (see ``registry.build_model``)."""
