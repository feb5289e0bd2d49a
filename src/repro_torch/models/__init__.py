"""Model code of the port: config, layers, the dense transformer and the registry."""
