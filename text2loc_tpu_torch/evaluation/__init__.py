"""Gallery encoding and retrieval of the port."""
