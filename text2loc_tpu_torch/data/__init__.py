"""Device-batch containers and eval transforms of the port."""
