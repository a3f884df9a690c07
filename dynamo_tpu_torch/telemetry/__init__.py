"""Request-latency and HTTP service metrics of the port's frontend."""
