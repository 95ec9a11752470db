"""Dense decoder of the port: layers, model assembly, weight bridge."""
